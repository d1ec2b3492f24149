#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version on the card, serves llama3-8b (full
width and depth, random bf16 weights from a seed) through the paged
engine and its HTTP front, in bf16 and then with int4 weights and an int8
KV arena, and behind the OpenAI front on a full pool, serves mla-8b (the
same, with Multi-head Latent Attention) over a bf16 and then an int8
latent arena, serves llama3-8b tensor-parallel on an in-process mesh (bf16
over 4 shards, int4 with an int8 arena over 2), serves Mixtral-8x7B (full
width and depth, int4 weights drawn and quantized a layer at a time)
through its sparse-MoE layers, serves llama3-8b with per-request LoRA
adapters (bf16, then int4 weights over an int8 arena), serves Gemma-7B,
Qwen2-7B, Qwen3-8B and Mistral-7B (past its 4096-token window) at full
width and depth and llama3-70b with int4 weights over an int8 arena,
serves Gemma-2-9B and Gemma-3-12B (past their windows) and llama3-8b with
the prefix cache off through the contiguous decode loop, then
trains Llama-3-8B widths at 4 layers, mla-8b widths at 4 layers (flash at
D = 192), and Llama-3-8B widths as ring attention over 4 sequence shards
in one process, fine-tunes llama3-8b with LoRA, trains Mixtral-8x7B
and DeepSeek-V2-Lite widths at reduced depth and fine-tunes the whole
DeepSeek-V2-Lite with LoRA (``--moe-train`` runs that phase, 9e, alone),
then trains Gemma-2-9B and Gemma-3-12B widths at reduced depth, fine-tunes
the whole Gemma-2-9B with LoRA and serves its adapter on the contiguous
loop (``--gemma-train`` runs that phase, 9g, alone).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failed check raises: the script exits nonzero and does not
print the final ``ok`` line):

1. card: name and power limit (nvidia-smi), printed before any number;
2. build: ``csrc/paged_attention_multi.cu``,
   ``csrc/paged_attention_multi_quant.cu``,
   ``csrc/paged_attention_multi_mla.cu``,
   ``csrc/paged_attention_multi_mla_quant.cu``, ``csrc/int4_matmul.cu``,
   ``csrc/int4_expert_matmul.cu`` and ``csrc/flash_attention.cu`` with nvcc
   for sm_90a (one nvcc each, started together), and the Triton RMSNorm
   kernel, with their seconds and ptxas register/spill lines; where the
   toolkit has ``cuobjdump``, the HGMMA (wgmma) and HMMA counts of every
   kernel of the seven tensor-core sources (an instantiation of either
   paged kernel, ``paged_attention_multi`` or the int8-page
   ``paged_attention_multi_quant``, ``flash_fwd``, ``flash_dq``,
   ``flash_dkv``, either MLA latent kernel, ``int4_expert_matmul`` or a
   prefill-regime ``int4_matmul`` or ``int4_matmul_sharded`` without HGMMA,
   or a decode-regime one of the last two with neither HGMMA nor HMMA,
   fails the phase, as does a kernel missing from its library), and the
   instructions ``int4_expert_matmul`` spends to unpack a staged q4 byte
   (``sass_unpack_mix``); a line of ptxas's that it serialized the wgmmas
   (C7514 or its kin) in the build log of ``csrc/int4_expert_matmul.cu``
   fails the phase;
3. kernels vs plain on the card, at the shapes the 8B main path gives
   them: ``paged_attention_multi`` (decode K=1 B=8 with ragged lengths up
   to 2048, K=4 B=8, K=5 B=8, a 1024-token prefill chunk behind a 100-token
   prefix; tables carry stale ids of garbage pages past ceil(len/T)),
   ``paged_attention_multi_quant`` (the same three cases and K=5 B=8, the
   verify width of ``--speculate 4``, over int8 pages
   the model's ``_kv_quant`` made from the same K/V), the
   single-token forms ``paged_attention`` and ``paged_attention_quant`` at
   the decode shape, ``int4_matmul`` at each distinct projection shape of
   the 8B model at 8 and 1024 rows, ``int4_expert_matmul`` at Mixtral's
   expert projections (8 experts, gate/up 4096 -> 14336, down 14336 ->
   4096) over buffers of 8, 40 and 1024 rows an expert (a decode step of 8
   slots, a K = 5 verify step, a 1024-token chunk) filled up to the counts
   of a seeded top-2 router (every row checked; rows past a count exactly
   zero; the launch at full capacity must give the same bytes; controls:
   nibbles swapped, each expert given its neighbour's weights, each group
   its neighbour's scale; times with the counts and at full capacity,
   beside ``torch.bmm`` by the dequantized bf16 experts as a yardstick),
   and
   ``rms_norm`` (8 and 1024 rows of 4096 for serving; x (8, 2048, 4096)
   needing gradients with an f32 weight for training, where y, dx and dw
   are each held against autograd of the plain version). Each case prints
   the max abs
   error and its share of the tolerance (each element within 1e-4 +
   1e-2 |plain|, 1.3 bf16 ulps; broken variants are scored against it
   and must read above 1x: for attention p.v accumulated in bf16, P
   rounded to bf16 before P.V and a page lost from the long contexts,
   for int8 pages also the scales
   ignored and each key's scales taken from the neighbouring kv head, for
   int4 the two nibbles of each byte swapped, each group
   given its neighbour's scale and each weight multiplied by its scale in
   bf16 before the product), the kernel's median time (CUDA events,
   L2 flushed before every launch), its bound (bytes over 3.35 TB/s or
   operations over the peak for their type, whichever is larger), the
   plain version's time, and one PyTorch library call's time for the
   same function (SDPA over the gathered K/V with the same mask,
   ``F.rms_norm``, ``torch.ops.aten._weight_int4pack_mm`` on the same
   nibbles and bf16 group scales, held to the plain version by relative
   L2, beside ``torch.matmul`` by the dequantized bf16 weight as a
   yardstick) or, where no single call takes the kernel's inputs (int8
   pages), a labelled yardstick (SDPA over the dequantized K/V), which the
   port itself never calls;
3b. MLA kernels vs plain at mla-8b's shapes (32 heads, latent 512, rope
   64, 16-token pages, f32 absorbed queries): ``paged_attention_multi_mla``
   and ``paged_attention_multi_mla_quant`` (int8 latents that the model's
   ``_kv_quant`` made) at decode K=1 B=8 over the burst's contexts
   (252-881) and at a 1024-token prefill chunk behind a 100-token prefix,
   and the single-token ``paged_attention_mla`` and
   ``paged_attention_mla_quant`` at the decode shape; the tolerance of
   phase 3, controls (the rope term dropped, a page lost, the causal floor
   off at K > 1, q in bf16 alone, the scales ignored for int8) that must
   read above 1x, the
   kernel's, the plain version's and a labelled SDPA yardstick's times
   (q = [q_lat, q_rope], k = [c, kr], v = c, one kv head), and the bound;
   the multi-token forms again at DeepSeek-V2-Lite's 16 heads (phase 7v's
   shapes), beside its other kernel cases: ``int4_expert_matmul`` at 64
   experts of 1408 under top-6 counts (decode and a 1024-token chunk),
   ``int4_matmul`` at its projections (the prefix's w_down one group of
   10944 in-elements), ``rms_norm`` at 2048 and 512, flash at D = 192
   over 16 heads;
4. engine: ``ServingEngine`` for llama3-8b, 8 slots, cache_len 2048,
   16-token pages; 8 greedy requests of 200-900 prompt tokens (two share
   a 96-token prefix), 32 new tokens each. The launch counters are set to
   0 just before and read just after; all 8 must finish, the prefix hit
   must register, both kernels' counters must have risen. Launches are
   also read per path, each against the engine's own step counters: the
   decode-only stretch after the burst's last prefill, and a prefill-only
   stretch (a 1500-token prompt, two chunks, one new token); every step
   or chunk must launch the attention kernel once per layer and the norm
   kernel twice per layer plus once. The single-token forms, on no model
   path, are counted in the same way and must stay at 0, here and in 7b;
5. repeat: one prompt served twice more gives the same tokens both times;
6. HTTP: the front on a free port answers one POST /generate with 200;
7. drain: the engine drains and the pool holds zero leaked pages;
   before it, the independent check: the engine path's last-token logits
   for one measured prompt against a plain f32 forward of the same bf16
   weights (no paging, no kernels: ``_attention_plain`` and
   ``_rms_norm_plain``, one layer upcast at a time), within a relative L2
   limit that the same forward with one layer skipped must exceed;
Step graphs (phases 4, 7s, 7b, 7c, 7d). Each engine captures its decode
   step (and, with speculation, its K = 5 verify step) as a CUDA graph at
   ``start()``; every stretch above holds graph replays equal to decode
   steps, so no eager model step runs on the card's engine path, and the
   launch counts per step are counted per replay. On each engine, idle
   after its burst (the speculative run of 7s for K = 1 and K = 5): (g5)
   one capture per graph and 0 recaptures in
   ``debug_snapshot()["graphs"]``, replays equal to the engine's decode
   steps; then over 8 slots of the burst's contexts in pages from the
   engine's own pool, seeded random rows: (g1) two replays against the
   eager ``paged_verify_step`` on a copy of the arena, the second with new
   tokens, lengths + K and a page only its table names: logits max abs
   difference (expected 0: the same kernels on the same inputs; else held
   to the engine's limit) and every arena section; (g2) the kernel nodes
   of the captured graph (what each replay launches, from the graph's own
   description), the paged-attention, ``rms_norm`` and ``int4_matmul``
   kernels counted by name equal to the launches the capture recorded; (g3) the step wall eager (the five tensors built on
   the host, as the engine did before) against graph, in turns; (g4)
   allocated, max allocated and reserved device memory before and after
   the capture;
7s. speculative engine, on the bf16 params of phase 4: (a)
   ``paged_verify_step`` at K=5, B=8 over a table whose first four slots
   share a 96-token prefix's pages, each of the 5 rows within phase 7's
   limit of a plain f32 forward of the slot's whole sequence; then five
   engine runs (8 slots, cache_len 2048, 64 new tokens each): speculate_k
   4 with 256-token chunks and the same without speculation, in turns
   (speculative, plain, plain, speculative), then speculate_k 4 with
   serving_chunk_tokens 0, each over the same traffic: 4 greedy
   repetitive prompts of 400-800 tokens (random weights do not copy from
   their context, so two repeat a seeded 24-token phrase, where drafts
   are rejected, and two repeat one token that the model maps to itself:
   a one-token context gives every position the same hidden state, so a
   sweep of the vocab without attention finds such tokens, and their
   streams repeat them, drafts accepted), the first 4
   prompts of phase 4 (drafts rejected), a sampled request (temperature
   0.8, seeded) and, once the 9 are prefilled, a greedy 1500-token prompt
   beside the streams still decoding. Held: (b) greedy tokens of the speculative
   engine equal the plain one's up to any first divergence, where the
   plain f32 forward's top-2 margin must be under SPEC_TIE_MARGIN of the
   logits' RMS; (c) accepted drafts, rollback pages and interleaved steps
   all above 0; (d) every verify step, plain step and chunk launching 32
   ``paged_attention_multi`` and 65 ``rms_norm``, no other attention
   kernel; (e) HTTP and drain with zero leaked pages. Reported: per-stream
   decode tokens/s of each engine, the acceptance rate, the largest token
   gap of the streams decoding through the 1500-token prefill (with
   interleave and without), the divergences and their margins;
(f) flight recorder: every burst (phase 4, 7b-7d) and each 7s run
   prints the per-mode medians of its step records (wall, schedule,
   kernel, sample, commit; the ring at most ``recorder_bytes``); after
   phase 4, its burst four more times on fresh engines, the recorder off,
   on, on, off (wall, per-stream tokens/s, TTFT);
7o. OpenAI front, on phase 4's params: an engine of 2 slots, cache_len
   2048 and ``kv_pool_pages`` at its minimum (256) with the byte
   tokenizer. (a) two 2040-token prompts whose page runs hold the whole
   pool, the engine thread held at the first one's first token until a
   1500-token prompt has found no up-front run and prefilled through the
   dense-scratch route (counted once); all three finish, none
   EngineOverloaded; that route's last-token logits against the plain
   f32 forward (limit 0.1, skipped-layer control); the TTFT of a
   1500-token prompt through the native route (n = 1) and the dense one
   (an n = 2 group), in turns from an empty trie. Behind the HTTP front:
   (b) chat with n = 2 (two choices from one dense prefill, usage, each
   greedy choice against the other and against /generate of the same
   prompt up to a near-tie (SPEC_TIE_MARGIN, logit_bias added), a stop
   string cutting the text, completions' logprobs finite and <= 0);
   (c) streamed completions: SSE chunks concatenating to the
   non-streamed text, ending in ``data: [DONE]``; (d) /v1/embeddings of
   1000 tokens against the plain f32 forward's mean-pooled final-norm
   state (limit 0.1), 1025 tokens -> 400; (e) every launch of the phase
   accounted for: ``flash_fwd`` 32 per dense prefill head and per embed,
   ``rms_norm`` 65 per each, per dense chunk, per decode step and per
   paged chunk, ``paged_attention_multi`` 32 per step and paged chunk,
   the other attention wrappers 0, replays equal to decode steps; then
   (g1)-(g5) with 0 recaptures, HTTP and drain with zero leaked pages;
7h. HF load: llama3-8b widths at 2 layers (phase 4's first two layers)
   exported by ``to_hf_state_dict``, written as two safetensors shards and
   an index by a writer in this script, loaded onto the card by
   ``load_hf``: every leaf bit-identical to the source; bytes and seconds;
7b. quantized engine: the bf16 engine freed, the engine the serve CLI
   builds from ``--int4 --kv-int8`` (8 slots, cache_len 2048) over the same
   seeded bf16 params, which it quantizes on the card; the same burst,
   stretches and repeat, each step or chunk launching exactly 32
   ``paged_attention_multi_quant``, 225 ``int4_matmul`` (7 a layer and the
   head), 65 ``rms_norm`` and no ``paged_attention_multi``,
   ``paged_attention`` or ``paged_attention_quant``; the weight and
   arena bytes and peak memory; the independent check against a plain
   f32 forward of the dequantized weights over unquantized K/V (its own
   limit, the same skipped-layer control), the gap to the bf16 engine's
   logits (information only), HTTP, drain with zero leaked pages;
7t. tensor-parallel serving (in-process meshes: every shard on the one
   card, each shard's kernels launched at its own widths). (a), with the
   kernels of phase 3: ``int4_matmul_sharded`` (row 15) at llama3-8b's
   projections out-sharded over 2 and 4 shards (a shard's wq/wo 4096 ->
   2048 / 1024, wk/wv -> 512 / 256, gate/up -> 7168 / 3584, down 14336 ->
   2048 / 1024, lm_head -> 64128 / 32064) at 8 and 1024 rows: one launch
   for every shard against the plain version (row 13's tolerance), a
   control with the shards' column blocks swapped that must miss, row 13
   on the gathered weight (the same bytes where both split the groups
   alike, else the split counts printed), times of the kernel, its bound,
   the plain version, ``_weight_int4pack_mm`` on the gathered weight
   (library) and once a shard, row 13 on the gathered weight and on one
   shard's slice (what one rank of a multi-card deployment launches).
   (c), before 7b, on phase 4's bf16 params: the engine the serve CLI
   builds from ``--tensor-parallel 4`` (Hkv 8 -> 2 a shard; wo and w_down
   row-parallel, their shards' partial sums added), its own copy of the
   tree sharded; (b), after 7b, on 7b's quantized params: ``--int4
   --kv-int8 --tensor-parallel 2``. Each: weight bytes (and a shard's),
   arena pages (and a shard's page bytes), peak memory; the burst of phase
   4, stretches and repeat with exact launches per step (the paged kernel
   once a shard and layer; with int4 225 ``int4_matmul_sharded``, one a
   projection, and no ``int4_matmul``); (g1)-(g5); the last-token logits
   against the one-device engine's on the same weights within
   ``TP_INT4_REL_L2_LIMIT`` / ``TP_BF16_REL_L2_LIMIT`` (set before the
   first run), the independent check against the plain f32 forward at the
   one-device engine's limit with its skipped-layer control; HTTP, drain
   with zero leaked pages;
7l. multi-LoRA engine, after 7t (c), on phase 4's params: the engine the
   serve CLI builds from ``--lora-rank 16 --lora-targets`` (all seven:
   wq, wk, wv, wo, w_gate, w_up, w_down) ``--max-adapters 4`` (8 slots,
   cache_len 2048; stacks allocated once, 0.419 GB). Three adapters from
   the port's ``apply_lora`` (explicit generators), B redrawn N(0,
   sigma^2) with sigma doubled from LORA_SIGMA0 until an adapter moves
   the base's f32 last-token logits by 1.5 x LORA_MIN_MOVE (each must
   move them by LORA_MIN_MOVE), registered after the graph captures. The
   burst of phase 4 with adapter ids cycling base, a1, a2, a3 (every
   decode batch mixes all four; the shared-prefix pair, base and a1, hits
   nothing and shares no page), its stretches and repeat with exact
   launches per step (32 ``paged_attention_multi``, 65 ``rms_norm``: the
   deltas are plain PyTorch and launch no counted kernel), an n = 2 group
   under a2 through the dense-scratch route (32 ``flash_fwd``). (a) Each
   of base, a1, a2, a3: the last-token logits of one prompt (the engine's
   one-chunk prefill with its stacks and that slot) against a plain f32
   forward over the merged weights (``layer_f32``: base + A @ B * scale
   in f32, a layer at a time), limit 0.1; (b) control: each adapter's
   logits against the next adapter's merge, above the limit; (c)
   (g1)-(g5) with mixed ids (slot i on adapter i mod 5), launches per
   replay unchanged, then a4 registered and a1 rewritten (B negated) in
   place: 0 recaptures, a1's trie subtree dropped, the rewritten a1
   within the limit of its new merge and above it off the old one; (d)
   the stacks' bytes and the serving peak, then ``step_profile``'s
   ``lora_profile`` (decode replay and 1024-token chunk, adapters of rank
   16 over all seven targets, mixed ids, against the same steps without,
   in turns; ``step_profile --lora-rank 16`` profiles the default
   targets); HTTP, drain with zero leaked pages. (e), after 7t
   (b): the same (a)-(c) from ``--int4 --kv-int8 --lora-rank 16`` over
   7b's quantized tree at full depth (32 ``paged_attention_multi_quant``,
   225 ``int4_matmul``, 65 ``rms_norm`` a step; the reference dequantizes
   the int4 base; limit 0.15);
7c. MLA engine: the engine the serve CLI builds from ``--model mla-8b``
   (8 slots, cache_len 2048, 16-token pages) over random bf16 weights from
   the same seed; its arena must be 2048 + 1 latent pages of 589,824 B;
   the same burst, stretches and repeat, each step or chunk launching
   exactly 32 ``paged_attention_multi_mla`` and 97 ``rms_norm`` (attn,
   c and mlp norms a layer and the final one) and no other attention
   kernel (the dense paged kernels, the int8 latent kernel and the
   single-token forms, all read from the counters); the independent check
   against a plain f32 forward in MLA's direct form (per-head K = [c w_uk,
   kr], V = c w_uv, ``_attention_plain`` at head_dim + rope_dim, no
   paging, no absorption, no kernels), limit 0.1, with the skipped-layer
   control; HTTP, drain with zero leaked pages; (e) then the dense-scratch
   route, whose prefill runs MLA's direct form through the flash kernels
   at D = 192, on an engine of 2 slots, cache_len 2048 and kv_pool_pages
   256 over the same weights: a 1500-token prompt onto a pool that two
   2040-token runs hold (the route taken once, all three finish, its
   logits against the plain f32 forward), an n = 2 greedy group (equal
   members), an ``embed`` of 1000 tokens against the plain f32 pooled
   state (the phase's limit); launches from counts set to 0 before it:
   ``flash_fwd`` exactly 32 per dense prefill head and per embed, no
   ``flash_dq``/``flash_dkv``, 97 ``rms_norm`` per head, embed, dense
   chunk, step and paged chunk, the latent kernel 32 per step and paged
   chunk, every other attention kernel 0; (g1)-(g5), HTTP, drain with zero
   leaked pages;
7d. the same from ``--model mla-8b --kv-int8`` (int8 latents, pages of
   299,008 B), through ``paged_attention_multi_mla_quant``, the
   independent check at limit 0.15, the gap to 7c's logits
   (information only), and (e) over int8 latents; then the MLA weights are
   freed;
7m. MoE engine: the engine the serve CLI builds from ``--model
   mixtral-8x7b --int4`` (8 slots, cache_len 2048, 16-token pages, bf16
   arena), its weights drawn from the seed and quantized a layer at a time
   (``init_quantized_params``: the 93 GB bf16 tree never exists); weight
   and arena bytes and peak memory, which must stay under 80 GB; the same
   burst (prompt tokens below Mixtral's 32000), stretches and repeat, each
   step or chunk launching exactly 96 ``int4_expert_matmul`` (gate, up
   and down a layer), 129 ``int4_matmul`` (wq, wk, wv, wo a layer and the
   head), 32 ``paged_attention_multi``, 65 ``rms_norm`` and no other
   attention kernel; (g1)-(g5); the independent check against a plain f32
   forward of the dequantized weights (f32 routing, each token's top-2
   experts, no capacity buffer), one layer at a time, limit 0.15, with the
   skipped-layer control and the count of (token, layer) pairs whose
   router's 2nd and 3rd probabilities lie within 1e-3; (h) the same int4
   tree laid out again through the serve CLI at ``--tensor-parallel 2
   --expert-parallel 2`` in one process (``moe_ep_tp_phase``; no second
   draw, the experts held once): the burst with exact launches a step
   (64 of row 8, 129 of row 15, 96 of row 14: one launch over every
   expert shard's experts, 65 of row 12; listed as ``serve_moe_ep2_tp2``),
   (g1)-(g5), 7m's layer check on this engine (the one-device tree the
   references' weights) with the control of wq's two tensor shards
   swapped in every layer, which must miss (in one process the expert
   split is the identity, so this holds the tensor split, the layout and
   the launches); the greedy tokens and the
   checked prompt's logits against the one-device engine's and the plain
   f32 forward's, reported as 7m reports its own; the peak; HTTP, drain
   with zero leaked pages; then the Mixtral weights are freed before
   training;
7v. DeepSeek-V2-Lite (``deepseek_phase``) at full width and depth, its
   norms drawn at U(0.75, 1.25): (a) the engine the serve CLI builds from
   ``--model deepseek-v2-lite`` over the bf16 tree (8 slots, cache_len
   2048, 16-token pages; the arena's ``c_pre``/``kr_pre`` sections for the
   dense first layer, 497,664 bytes a page), weight, arena and peak bytes
   under 80 GB, phase 4's burst with exact launches a step or chunk (27
   of row 10, 82 ``rms_norm``, no other attention kernel), (g1)-(g5), the
   last-token check against the plain f32 forward (reported) and the
   layer check (``moe_layer_check``, generalized to top-6 without
   renormalization, the shared experts and the dense layer 0, gated at
   0.05, its controls failing, with the count of (token, layer) pairs
   whose 6th and 7th probabilities lie within the tie margin), HTTP and
   drain; (c) over the same tree the dense-scratch route (2 slots, the
   pool at its minimum: a 1500-token prompt, row 1 at D = 192 27 times a
   head) and ``embed`` (within 0.15 of the plain forward's pooled state),
   and ``--prefix-cache off``, whose greedy tokens must equal the paged
   loop's or part from them at a near tie (``SPEC_TIE_MARGIN``); (b)
   ``--int4 --kv-int8`` from a tree drawn and quantized a layer at a
   time, the same checks with 78 ``int4_expert_matmul``, 163
   ``int4_matmul`` and 27 of row 11 a step; (f) (b)'s tree again at
   ``--expert-parallel 2`` (``deepseek_ep_run``; tensor 1, the experts
   held once) on (b)'s burst with (b)'s launches a step, its greedy
   tokens against (b)'s, reported: the computation is (b)'s, so this ~4 s
   run holds DeepSeek's ``--expert-parallel`` path through the serve CLI
   and the engine's expert mesh and counts its launches; (d)
   ``step_profile --model deepseek-v2-lite`` in bf16 (with a training
   step at 4 layers; the int4 profile was cut to pay for this PR's new
   phases);
7f. the other dense families, one at a time at full width and depth,
   the card freed between them: gemma-7b, qwen2-7b, qwen3-8b and
   mistral-7b, bf16 weights from the seed with their q/k/v biases, q/k
   norm weights and zero-centered norm weights drawn away from the JAX
   init's identity (``draw_family_branches``), each through the engine
   the serve CLI builds (8 slots, cache_len 2048, 16-token pages): phase
   4's burst, stretches and repeat with exact launches a step or chunk
   (the paged kernel once a layer, ``rms_norm`` 2L + 1, or 4L + 1 with
   Qwen3's q/k norm; under int4 ``int4_matmul`` 7L, plus one for an
   untied head), (g1)-(g5), the serving peak, the decode replay's and a
   1024-token chunk's time between CUDA events, and the last-token
   logits against the plain f32 forward of the same weights with every
   branch (``family_logits``) within 0.1, with one control a branch
   (bias dropped, q/k norm dropped, no embedding scale, SiLU for GeGLU,
   w for 1 + w) and the skipped middle layer, each of which must miss;
   gemma-7b and qwen2-7b again with ``--int4 --kv-int8`` (limit 0.15);
   mistral-7b past its window (``window_run``: cache_len 8192, a
   4600-token prompt, 300 greedy tokens: pages recycled, the final
   step's logits against the windowed f32 forward, the full-causal
   forward a control, and a ``--speculate 4`` engine taking no
   speculative step); then llama3-70b ``--int4 --kv-int8``
   (``llama70b_phase``: drawn and quantized a layer at a time, the burst,
   (g1)-(g5), the last-token check reported and the layer check gated);
   phase 3 holds rows 8 and 9 at these models' heads and window, row 12
   at their widths, row 1 at Gemma's serving shape and row 13 at
   llama3-70b's widths;
7x. observability (``observability_phase``), right after phase 4 on its
   tree: the engine behind ``serve_main.serve`` with profile capture on,
   its spans exported to a JSONL file and a ``ReplicaReporter`` at 0.5 s
   against a stub router the script starts; phase 4's burst over HTTP,
   each request with a caller ``traceparent``: (a) every answer carries
   the caller's trace id, ``/debug/traces`` holds exactly the request's
   four spans (children contiguous, summing to the root within 1 ms), the
   roots' ``decode_steps`` sum to at least the burst's replays, and the
   export file holds the same spans; (b) ``/metrics`` deltas against the
   engine's own counts (admitted, decode steps = replays, prefill chunks,
   the shared prefix's hit, the TTFT / latency / queue-wait counts, the
   inter-token count = the tokens after each first, the step-wall count =
   the recorder's new records, 0 recaptures) and the launches (32 and 65
   a step or chunk); (c) ``/debug/profile?seconds=1`` while bursts keep
   the slots busy: the Chrome trace's kernel events hold
   ``paged_attention_multi`` and ``rms_norm`` at 32 : 65 a step within
   one step at each window edge, their device time printed; (d) one
   register and heartbeats whose stats carry exactly the JAX reporter's
   keys and whose schema-1 metrics snapshot agrees with ``/metrics``, and
   a deregister after the drain; (f) the cost meter, on by default
   (``cost_checks``): requests under two ``X-Tenant`` values and one
   OpenAI ``user``, then ``/debug/costs``: each tenant's chip-seconds the
   sum of its requests' walls x 1 card within 1 ms a request, its dollars
   chip-seconds x the ``h100`` row's price / 3600, the request spans
   carrying the same, and a heartbeat carrying the ledger; (e) the
   burst's decode tokens/s per stream and (g3)'s replay wall beside phase
   4's (reported); (g1)-(g5);
7k. disaggregated serving (``disagg_phase``, after 7x on phase 4's tree;
   ``--disagg`` runs it alone): the router's two hops played by hand.
   (a) the device rung between engines of this process (2 slots,
   512-page arenas) behind ``serve_main.serve`` fronts: 2 monolithic and
   2 streamed (256-token chunks, window 8) hops of phase 4's prompts,
   each run's adopted pages bit-equal to the exporter's, the decode
   replica's greedy tokens equal to a unified engine's (the same path:
   cached pages, then the tail) after one tail chunk, 0 downgrades; (b)
   the wire rung to a decode ``serve_main`` process on the card (a
   prefill process beside it, both llama3-8b from the seed): monolithic
   and streamed, ``/metrics`` deltas against the hops, a truncated blob
   answered 400 with the decode pool unchanged; (c) the shm rung between
   the two processes, "path": "shm" and 0 downgrades; (d) a pull over
   ``/kv_fetch`` -> ``/kv_pull`` (the tail alone prefilled), then an
   evicted run: 404 gone at the owner, a gone fetch, a whole prefill;
   (e) ``--kv-int8`` over the wire here, and inside 7v DeepSeek-V2-Lite
   ``--int4 --kv-int8`` (``deepseek_handoff``), ``section_spec`` equal
   on both sides; (f) export, transfer and adopt ms a page and bytes a
   second a rung, and a two-hop TTFT beside a unified one, reported;
7g. the contiguous decode loop (``interleave_engine_run``): llama3-8b
   with ``--prefix-cache off`` on phase 4's tree (a linear cache), right
   after phase 4; after 7f, gemma2-9b (cache_len 8192, a mixed cache of
   5120-slot rings and full-length global sections) and gemma3-12b
   (cache_len 4096, rings of 2048) in bf16 and ``--int4 --kv-int8``, one
   at a time at full width and depth, their norms, sandwich norms and
   q/k norm drawn away from identity (gemma2-9b's final norm drawn 24
   higher, so that its logits reach the soft cap of 30), each through
   the engine the serve CLI builds with 1024-token chunks: weight, cache
   and peak bytes; phase 4's burst behind a registered 96-token prefix
   (the dense prefix store: both prompts that start with it hit), with
   exact launches a decode step or prefill call (``rms_norm`` 2L + 1,
   4L + 1 with sandwich norms, 6L + 1 with the q/k norm too; under int4
   ``int4_matmul`` 7L; no paged kernel; ``flash_fwd`` L a prefill head);
   (g1)-(g5) on the decode graph; the decode replay's and a 1024-token
   chunk's time; the last-token logits of a burst prompt against the
   plain f32 forward with every branch (``interleave_logits``: per-layer
   windows, both RoPE tables, both soft caps, sandwich norms) within 0.1
   (0.15 under int4/int8); and the Gemma engines past their window (a
   5600-token prompt and a 3000-token prompt, both already round their
   rings, with 100 greedy tokens each) and llama3-8b's linear cache (a
   1500-token prompt with 100), the
   final decode step's logits held likewise; each control must miss:
   soft caps dropped, sandwich norms dropped, the global window on local
   layers, the global RoPE table on local layers, the middle layer
   skipped, and a ring that ignores ``abs_pos``; phase 3 holds row 1 at
   Gemma 2's and 3's prefill heads (soft cap 50, windows 4096 and 1024),
   rows 8 and 9 at Gemma 2's heads with the soft cap, row 12 at Gemma 3's
   width and q/k rows, and row 13 at Gemma 3's widths;
8. flash kernels vs plain on the card: ``flash_fwd``, ``flash_dq`` and
   ``flash_dkv`` at the training shape (B 8, Hq 32, Hkv 8, S 2048, D 128,
   causal), a ragged S=1000, D=64, D=256, GQA group 1, a window, a soft
   cap, non-causal, and the serving shape of a dense prefill head or an
   embed (B 1, Hq 32, Hkv 8, D 128, causal, S 1024 and 1000), and MLA's
   direct form at D = 192 (one kv head a q head, v zero past its first
   128 columns): the MLA train shape (B 8, Hq 32, S 2048) and a dense
   prefill head (B 1, S 1024). Each kernel is held per element against
   its plain version on the same inputs (the backward kernels take the forward
   kernel's lse and delta), with the tolerance of phase 3 (lse: 1e-4 +
   1e-5 |plain|, f32); the whole autograd path against autograd through
   ``_attention_plain`` in f32 (gradients within 1% of each tensor's
   largest magnitude: delta comes from the bf16 o, as in the JAX
   package); broken controls scored with the same check
   (``flash_controls``: p.v accumulated in bf16 over 64-key tiles; P
   rounded to bf16 before P.V; dK/dV with one q head of each group
   dropped; dS and P rounded to bf16 before the products that accumulate
   dq, dk and dv, each of the three scored and the least share kept;
   under a soft cap dQ and dK/dV without it, each of dq, dk, dv scored;
   under a window the three kernels at the window one short, some output
   scored; each must read above 1x); times of each kernel, its plain
   version and the library's forward / autograd backward (SDPA, or under
   a soft cap, which SDPA does not take, compiled ``flex_attention`` with
   the cap as its score function and the band as its block mask; the
   backward computes dq, dk and dv together, so it is the library time of
   both backward kernels), and its bound (operations over the bf16 tensor
   peak, or bytes). Then row 16, the kernels at a ring offset,
   on one shard of the ring-train phase (B 2, Hq 32, Hkv 8, S 2048, D 128,
   the q chunk ``q_offset`` positions after the K/V chunk): q_offset 2048
   and 6144 (every key visible), 2048 with window 512 (a band at the chunk
   edge, rows past it see nothing), 2048 with soft cap 5, 2048 at D = 192
   (B 2, Hq 32, Hkv 32, MLA's direct form); the same checks
   and controls at the offset, plus the control of launching the same
   kernels at q_offset 0 on the same inputs, which must miss; SDPA non-
   causal with ``enable_gqa`` (or the band as a boolean mask), with the
   backend PyTorch picked; the bound over the visible pairs;
9. train: ``Trainer`` on llama3-8b widths at 4 layers (f32 master
   params, bf16 compute, remat "full"), batch 8 x seq 2048, 6 steps with
   warmup_steps=1 on one seeded synthetic batch repeated (fresh random
   batches can teach the model nothing past the uniform unigram, so their
   loss need not fall in 6 steps; one batch repeated must, though the
   embedding and head alone could memorise it, so a falling loss does not
   show the gradients right): every loss finite and the last below the
   first. Before the run, the gradients of step 1 (same params, same
   batch) through ``loss_and_grads`` against autograd of the plain f32
   forward (``_attention_plain``, ``_rms_norm_plain``, one row at a time):
   each leaf's relative L2 error and the global norm's relative error
   within their limits, step 1's reported grad_norm too, and a control
   with the dK/dV kernel's output zeroed that must exceed the leaf limit;
   per
   step the launches are checked exactly (flash_fwd 2L, flash_dq L,
   flash_dkv L, rms_norm 4L+1: each layer's forward and its recompute);
   step wall, tokens/s and peak memory;
9m. MLA train: phase 9 on mla-8b widths at 4 layers (MLA's direct form,
   the flash kernels at D = 192), the same gradient check and control, 6
   steps with exact launches a step (flash_fwd 2L, flash_dq L, flash_dkv
   L, rms_norm 6L + 1: the attn, c and mlp norms of each layer's forward
   and recompute, and the final one);
9r. ring train: phase 9's configuration at batch 2 x seq 8192 (the same
   16,384 tokens a step) on an in-process mesh of 4 sequence shards of
   2048 with ``ring_flash``. Step 1 on the seeded params and batch, held
   against autograd of a plain f32 forward over the whole sequence (causal
   attention a block of 2048 query rows at a time, exact softmax, each
   layer checkpointed; phase 9's leaf and norm limits), and against the
   unsharded flash forward and step on the same params and batch (logits
   relative L2 within 0.02, every leaf's gradient within 0.1); the control
   (every ring offset forced to 0) must exceed both. Then 6 steps on the
   repeated batch: launches exact per step (flash_fwd 2 x 4 x 4 under
   remat, flash_dq 4 x 4, flash_dkv 4 x 4, rms_norm 17: one launch of each
   kernel a ring step and layer, the shards stacked), the loss falls, step
   1's grad_norm within 1e-3 of the plain forward's; step wall (median of
   steps 2+), tokens/s and peak memory, beside 3 steps each of the
   unsharded flash step and the plain ring (``ring_flash=False``, the JAX
   default path), whose step-1 loss must sit within 2e-3 of the flash
   ring's;
9mr. MLA ring train: phase 9r on mla-8b widths at 4 layers (the flash
   kernels at D = 192 at each ring offset, row 16 at MLA's width), the
   same checks and controls (the plain f32 forward in MLA's direct form),
   4 steps with exact launches (rms_norm 6L + 1 a step);
10. train_main: the CLI on ``--model tiny`` with a checkpoint directory,
   twice; the second life must log ``resumed from checkpoint step 2``.
9f. fine-tune and telemetry (after phase 10). (a) phase 9's configuration
   (llama3-8b widths, 4 layers, its seeded batch of 8 x 2048) from the same
   seeded params, two steps with the naive loss and two with
   ``fused_ce_chunks`` 8: step 1's loss and grad norm within
   TRAIN_NORM_REL_LIMIT, the fused peak below the naive one by at least
   the bf16 logits' B x S x V x 2 bytes (printed beside x 4); (b) the fused
   run again under remat "dots": step 1 within the same limit of "full",
   launches exact and equal a step (flash_fwd 2L, flash_dq L, flash_dkv L,
   rms_norm 4L + 1), walls and peaks printed; (c) ``train_main.main
   --model llama3-8b`` (all 32 layers, random init) ``--lora-rank 16
   --fused-ce-chunks 8 --batch 4 --seq-len 2048 --steps 6 --data``
   (a seeded 61-token pattern repeated, written by the phase; the native
   loader must read it) ``--checkpoint-every 3 --telemetry-port
   --export-adapter --profile-dir``: the loss falls, every frozen leaf
   bit-identical after the run (checksums on the card), Adam moments only
   on the LoRA leaves, the logged trainable count, the peak within 80 GB,
   launches exact each step (64 / 32 / 32 / 129); the profile's Chrome
   trace holding exactly steps 3-5 (three ``train_step`` ranges, and rows
   1-3 and 12 at three steps' launches, 192 / 96 / 96 / 387, as
   ``step_profile.trace_kernel_events`` reads them, none over and at most
   FT_TRACE_LOST records a family lost by CUPTI); the untraced steps
   after the first (2 and 6) within FT_UNTRACED_REL of the fine-tune's
   median step without the profiler, their median and tokens/s;
   (d) one ``TPU_STEP_HEARTBEAT`` a step within 5% of the phase's own
   wall of the step, the last ``TPU_TELEMETRY`` line at step 6 with
   goodput in (0, 1] and the MFU of the h100 row's 989 TFLOP/s, exposure 0
   after the final durable save (telemetry and state file), a scrape of
   ``/metrics`` and ``/debug/train`` during the run naming one step, the
   goodput buckets summing to the wall within 1 ms; (e) the saves at steps
   3 and 6 staged and durable before the run returned, step 4's wall
   beside step 2's, a second ``train_main`` resuming at step 6 with every
   leaf bit-identical, a staged save whose writer raises leaving the
   previous checkpoint loadable (a tiny model on the card); (f) the
   exported adapter registered on a paged engine over the same bf16 base:
   8 greedy tokens against the argmax of a plain f32 forward of
   ``merge_lora`` (a differing token must be a near tie under
   SPEC_TIE_MARGIN), row 8 and row 12 launches exact a step or chunk.
9e. MoE training (``moe_train_phase``, after 9f). (a) phase 9 on
   mixtral-8x7b widths at 2 layers and (b) on deepseek-v2-lite widths at
   4 (its dense prefix layer and 3 routed; ``fused_ce_chunks`` 8), batch
   8 x 2048, routed at the capacity factor 1.25. The gradient check
   (``moe_train_grad_check``): the plain f32 forward routes itself, row by
   row with the capacity counts carried in the port's flat order (pass
   1), then its gradients of CE + the aux and z losses at those choices
   (pass 2); the port's step at the plain forward's choices
   (``route_top_k`` forced) within phase 9's leaf and norm limits; the
   control, each expert's output gathered from its neighbour's rows, must
   exceed the leaf limit; the port's unforced step reported beside, each
   choice that differs from the f32 router's on its own input within
   MOE_ROUTER_TIE of a tie. Then 6 steps: launches exact (flash_fwd 2L,
   flash_dq L, flash_dkv L, rms_norm 4L + 1 or 6L + 1), the loss falls,
   aux_loss finite, each routed layer's dropped share and load-balance
   loss logged, step 1's grad_norm within 1e-3 of the plain forward's,
   step wall, tokens/s and peak. (c) ``train_main --model
   deepseek-v2-lite`` (27 layers) ``--lora-rank 16 --lora-targets wq,wo
   --fused-ce-chunks 8 --batch 4 --seq-len 2048`` for 6 steps from a token
   file, checkpoints every 3: the summary line, the loss falling, every
   frozen leaf (the dense prefix, experts and router among them)
   bit-identical, moments on the adapters only, the peak (and the init's)
   within 80 GB, launches exact a step (53 / 26 / 26 / 160: the dense
   prefix layer, frozen and fed a frozen input, runs no backward), one
   heartbeat a step; a second life resumes at step 6 bit-identical.
9g. Gemma training (``gemma_train_phase``, after 9e). (a) rows 1-3 at a
   Gemma train step's heads (B1 Hq16 Hkv8 S8192 D256: Gemma 2's local
   layer under window 4096 and cap 50, its global layer, Gemma 3's local
   layer under 1024) and row 16 at one 4096-token shard of the seq = 2
   step, each against its plain version with phase 8's checks and
   controls and the library's times (compiled ``flex_attention`` under
   the cap, SDPA without it); each capped case again at q drawn LARGE_Q
   (8) times larger, where the scores reach toward the cap
   (``large_q_check``: each output within LARGE_Q_REL_L2 relative L2 of
   its plain version and per element, the cap left out of the backward
   beyond the L2 limit); row
   12 with gradients at 8192 x 3584, 8192 x 3840 and 131072 x 256 (its
   control a dx without the mean square's term). (b) gemma2-9b widths at 4
   layers and gemma3-12b at 6, batch 1 x 8192, fused loss: step 1's
   gradients against autograd of ``gemma_plain_nll`` within phase 9's
   limits (control: dK/dV zeroed), 6 steps with exact launches (flash_fwd
   2L, flash_dq L, flash_dkv L, rms_norm 8L + 1 or 12L + 1), the loss
   falling, one profiled step (rows 1-3's device time). (e) the seq = 2
   gemma2-9b step at 4 layers (ring flash) against the unsharded one
   (control: ring offsets 0). (c) ``train_main --model gemma2-9b`` (42
   layers) ``--lora-rank 16`` on all seven targets ``--fused-ce-chunks 8
   --batch 1 --seq-len 4096`` for 6 steps from a token file
   ``--export-adapter``: the loss falls, every frozen leaf bit-identical,
   launches 84 / 42 / 42 / 337 a step, the peak within 80 GB. (d) that
   adapter through ``serve_main --lora-rank 16 --dynamic-adapters`` on the
   contiguous loop over the frozen base, registered by ``POST /adapters``
   after the capture: a burst mixing adapter and base requests, launches
   exact; then the same flags with ``--prefix-cache off`` and a prefix
   registered by ``POST /prefix`` (the dense store): the adapter's first
   prompt over it fills its variant, the next hits it,
   a base prompt hits the base variant, re-registering the adapter drops
   its variant and the next prompt fills it again with the same tokens;
   (g1)-(g5) with mixed ids and 0 recaptures; the adapter's greedy tokens,
   with and without the prefix, against the same engine's over
   ``merge_lora``'s weights (equal, or parting at a near tie of the plain
   f32 forward).

The next-to-last line is the kernels JSON record (each kernel's
``launches`` counted on its own main path: the bf16 engine's burst for
``paged_attention_multi`` and ``rms_norm``, beside the speculative
engine's run as ``serve_spec`` and phase 7o as ``serve_openai`` (also
``flash_fwd``'s, on the dense route and embeddings), the quantized
engine's burst
for ``paged_attention_multi_quant`` and ``int4_matmul``, the MLA engines'
bursts for ``paged_attention_multi_mla`` and
``paged_attention_multi_mla_quant``, phase 7m's burst as ``serve_moe``
for ``int4_expert_matmul``, phase 7t (b)'s burst as ``serve_tp`` for
``int4_matmul_sharded`` (beside 7t (c)'s as ``serve_tp4_bf16``), the
training run for the flash kernels, beside the MLA training run as
``train_mla``, the ring-train runs as ``train_ring`` and
``train_ring_mla``, phase 9f's runs as ``train_naive_loss``,
``train_fused_loss``, ``train_dots`` and ``finetune_lora``, phase 9e's
as ``train_mixtral``, ``train_deepseek`` and ``finetune_deepseek_lora``
and phase 9g's as ``train_gemma2``, ``train_gemma3``,
``train_gemma2_seq2``, ``finetune_gemma2_lora`` and (``flash_fwd`` and
``rms_norm``) ``serve_gemma2_lora_contiguous``,
and the MLA dense routes of 7c and 7d (e) as
``serve_mla_dense`` and ``serve_mla_kv_int8_dense``, and phase 7l's
bursts as ``serve_lora`` and ``serve_lora_int4_kv_int8`` (their n = 2
groups' ``flash_fwd`` as ``serve_lora_dense_group`` and
``serve_lora_int4_kv_int8_dense_group``), phase 7f's bursts as
``serve_<model>`` and ``serve_<model>_int4_kv_int8``, and phase 7v's as
``serve_deepseek``, ``serve_deepseek_int4_kv_int8`` and (its dense route
and embed) ``serve_deepseek_dense``, and phase 7k's handoffs and the
decode replicas' requests as ``serve_disagg_device``,
``serve_disagg_kv_int8`` and ``serve_disagg_deepseek_int4_kv_int8``; the
single-token
forms lie on no model path, in this port as in the JAX package, and count
0), the last line
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every
number (engine and training phases included) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import dataclasses
import errno
import faulthandler
import gc
import importlib
import itertools
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

# when the script started: each phase header carries the seconds since
T_START = time.monotonic()
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
SEED = 20261016
# the kernels on the tensor cores, by source: every instantiation named so
# must hold wgmma instructions (HGMMA), except the decode regime of
# int4_matmul and int4_matmul_sharded (a tile of at most INT4_DECODE_ROWS
# rows), which may hold mma.sync (HMMA) instead; each name must be found in
# its library
TENSOR_CORE_KERNELS = {
    "paged_attention_multi": ("paged_attention_multi_kernel",),
    "paged_attention_multi_quant": ("paged_attention_multi_quant_kernel",),
    "flash_attention": ("flash_fwd_kernel", "flash_dq_kernel",
                        "flash_dkv_kernel"),
    "paged_attention_multi_mla": ("paged_attention_multi_mla_kernel",),
    "paged_attention_multi_mla_quant": (
        "paged_attention_multi_mla_quant_kernel",),
    "int4_matmul": ("int4_matmul_kernel", "int4_matmul_sharded_kernel"),
    "int4_expert_matmul": ("int4_expert_matmul_kernel",)}
INT4_DECODE_ROWS = 16
# Kernel and plain version both compute in f32 and round once to bf16, so
# they differ by at most one bf16 ulp of the output, which is <= 2^-7 |y|;
# RTOL is 1.3 ulps, ATOL covers f32 sum-order noise near zero. Both apply
# to each element against the plain version's |y|.
BF16_ATOL, BF16_RTOL = 1e-4, 1e-2
TOLERANCE = f"atol {BF16_ATOL} + rtol {BF16_RTOL}"
# the f32 lse of the flash forward: f32 sums in another order
F32_ATOL, F32_RTOL = 1e-4, 1e-5
# the flash gradients through autograd against autograd through the plain
# attention in f32: delta = rowsum(dO o) comes from the bf16 o in both the
# port and the JAX package, which moves dS by ~2^-8 |o| |dO| sqrt(D) per
# row; the gradients then sit within 1% of each tensor's largest magnitude
E2E_SCALE_RTOL = 1e-2
# the engine's last-token logits against the plain f32 forward of the same
# weights: relative L2 norm of the difference (the bf16 engine rounds at
# every layer of 32; see PERF.md for the readings this limit was set from)
ENGINE_REL_L2_LIMIT = 0.1
# the --int4 --kv-int8 engine's last-token logits against the plain f32
# forward of the same dequantized weights over unquantized K/V: the bf16
# activations of the bf16 engine (0.0588 there) plus the int8 rounding of
# every K/V row (half a step of amax/127, ~0.7% of a row's RMS). Set before
# the first run at 0.15: the skipped-layer control read 0.34 on bf16 weights
QUANT_ENGINE_REL_L2_LIMIT = 0.15
# the mla-8b engine's last-token logits against a plain f32 forward of the
# same weights in MLA's direct form (K and V materialised per head, no
# paging, no absorption): bf16 latents are held to the bf16 engine's limit;
# int8 latents add the int8 rounding of every c and kr row (half a step of
# amax/127), as the int8 arena did, and get the int8 arena's limit. Both set
# before the first run.
MLA_ENGINE_REL_L2_LIMIT = 0.1
MLA_INT8_ENGINE_REL_L2_LIMIT = 0.15
# the mixtral-8x7b --int4 engine's last-token logits against a plain f32
# forward of the same dequantized weights (f32 routing, each token's top-2
# experts, no capacity buffer) over unquantized K/V. Set before the first
# run: the bf16 activations cost the bf16 llama3-8b engine 0.0588; a token
# whose router's 2nd and 3rd probabilities lie within bf16 noise may pick
# another expert in one of 32 layers, which moves that token's MLP output by
# a share of the expert outputs' difference, so the int4 engine's 0.15 is
# kept rather than the bf16 engine's 0.1 (the phase prints how many (token,
# layer) pairs of the forward are such near ties)
MOE_ENGINE_REL_L2_LIMIT = 0.15
# phase 7x (f): a tenant's chip-seconds against the sum of its requests'
# walls (1 card), a request at a time: the ledger rounds each phase to
# 1e-6 s, the span's latency is the same perf-clock difference
COST_WALL_TOL_S = 1e-3
# phase 7m (h): the Mixtral tree again over an in-process expert x tensor
# mesh, held layer by layer as 7m is (MOE_LAYER_REL_L2_LIMIT)
EP7M, TP7M = 2, 2
# phase 7v (f): deepseek-v2-lite --int4 --kv-int8 at this expert degree
EP7V = 2
# ... which the first run missed (PERF.md, PR 12): the engine read 0.4856
# and its skipped-layer control 0.4797, so on random weights this check
# cannot tell a right engine from a broken one. A near tie flips one
# token's experts in layer 1; through attention the flips spread to 296 of
# 468 tokens by layer 31, and the random model amplifies each. The check
# is kept and reported; the gate is the layer check below, which holds
# each layer against the plain f32 layer on the engine's own input, so no
# flip carries from one layer to the next. Its limit: five times the bf16
# rounding of one layer's output (~2^-8 relative per element, ~0.01 in
# L2); its controls (the next layer's attention weights, each expert's
# neighbour's weights) read near 1.4. A choice of experts that differs
# from the f32 router's on the same input must lie within MOE_ROUTER_TIE
# of a tie: the engine's router logits carry the bf16 rounding of its
# input, which moved layer 0's probabilities by up to 0.0063.
MOE_LAYER_REL_L2_LIMIT = 0.05
MOE_ROUTER_TIE = 1e-2
# phase 7m: the serving memory must fit the card
CARD_BYTES = 80e9
# the training gradients (bf16 compute through the kernels) against autograd
# of the plain f32 forward of the same f32 master params: relative L2 error
# of each leaf, and relative error of the global norm (see PERF.md for the
# readings these limits were set from: every leaf 0.025-0.034, the norm
# 2.6e-5; with dK/dV zeroed, wk and wv read 1.0 and the norm 0.27)
TRAIN_GRAD_REL_L2_LIMIT = 0.1
TRAIN_NORM_REL_LIMIT = 1e-3
# the ring-train phase: llama3-8b widths at 4 layers, batch 2 x 8192 in 4
# sequence shards of 2048 (phase 9's 16,384 tokens a step)
RING_SHARDS, RING_BATCH, RING_SEQ = 4, 2, 8192
# the ring's forward and step 1 against the unsharded flash forward and
# step on the same params and batch, both bf16 through the kernels. Set
# before the first run: the two differ only in where attention rounds (the
# ring rounds each chunk's o to bf16 and merges in f32, the unsharded
# kernel rounds once), some 2^-9 relative an activation, a few roundings a
# layer over 4 layers: ~0.006 in the logits; the limit is 3x that. Each
# path's gradients sit 0.025-0.034 (relative L2 a leaf) off the plain f32
# forward's (phase 9), so the two paths' at most ~0.07 apart: the limit is
# phase 9's own leaf limit. A wrong mask moves attention by O(1): the
# control (every ring offset forced to 0) must exceed both.
RING_LOGITS_REL_L2_LIMIT = 0.02
RING_GRAD_REL_L2_LIMIT = TRAIN_GRAD_REL_L2_LIMIT
# the plain ring's (ring_flash=False, f32 online softmax, the JAX default
# path) step-1 loss against the flash ring's: relative
RING_PLAIN_LOSS_REL_LIMIT = 2e-3
# phase 9f, the fine-tune workload: (a) and (b) at phase 9's configuration
# with the LM-head loss over FT_CHUNKS vocab chunks; (c) a LoRA fine-tune of
# the whole llama3-8b through train_main: rank 16 on wq and wv (the CLI's
# default targets), batch 4 x 2048, 6 steps from a token file, async
# checkpoints every 3 steps
FT_CHUNKS = 8
FT_RANK, FT_BATCH, FT_SEQ, FT_STEPS, FT_EVERY = 16, 4, 2048, 6, 3
# the fine-tune's peak learning rate: train_main's warmup of 100 steps
# scales it by (step - 1) / 100, so its 6 steps run at 0 to 5% of it
FT_LR = 0.3
# the token file: a seeded pattern of FT_PATTERN tokens repeated over
# FT_WINDOWS windows of FT_SEQ tokens (the loss on it must fall)
FT_PATTERN, FT_WINDOWS = 61, 48
# (d): each heartbeat's step_time_s against the phase's own wall of that
# step (the heartbeat's interval also holds the batch's fetch and the
# telemetry's own work, well under 1% of a ~1 s step)
FT_HEARTBEAT_REL = 0.05
# (c): train_main --profile-dir traces steps 3-5 (the JAX main's two
# untraced steps, then three traced); the median of the two untraced
# steps after the first (2 and 6, so their mean) must stay within
# FT_UNTRACED_REL of FT_BASE_STEP_S, the fine-tune's median step without
# the profiler as PR 21's run read it (0.9341 s on an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md section 6)
FT_TRACED = (3, 4, 5)
FT_BASE_STEP_S, FT_UNTRACED_REL = 0.9341, 0.05
# kernel records of a family the trace may lack: CUPTI lost 1 to 3 of
# some 20,000 kernel records in two of five traces of those three steps
# (flash_fwd and rms_norm, on an NVIDIA H100 80GB HBM3; a graph replay's
# trace once lost records the same way), where a fourth step would add a
# whole step's 64 / 32 / 32 / 129; the three host ``train_step`` ranges
# are exact
FT_TRACE_LOST = 3
# (f): greedy tokens the served adapter generates
FT_SERVE_TOKENS = 8
# (d): runs of train_main, each on a newly picked free port, before the
# phase gives up on binding the telemetry server
FT_PORT_TRIES = 3
# phase 9e, MoE training: (a) mixtral-8x7b and (b) deepseek-v2-lite widths
# at the depth step_profile trains them (``train_layers``: 2 and 4 layers,
# the latter a dense prefix layer and 3 routed), batch 8 x 2048, 6 steps,
# (b) with the LM-head loss over FT_CHUNKS vocab chunks (its 102,400-entry
# vocabulary's f32 logits would be 6.7 GB); their gradient checks at the
# routing of the plain f32 forward hold phase 9's leaf and norm limits
# (see PERF.md for the readings: every leaf 0.015-0.034, the norm 3.7e-5
# and 8.4e-5; the neighbour-expert control 1.39-1.41), and the unforced
# step's flips MOE_ROUTER_TIE (they read within 1.3e-3 and 2.1e-4).
# (c) a LoRA fine-tune of deepseek-v2-lite at full depth (27 layers)
# through train_main: rank FT_RANK on wq and wo (an MLA layer has no wv),
# batch FT_BATCH x FT_SEQ, MOE_FT_STEPS steps from a token file, async
# checkpoints every MOE_FT_EVERY, telemetry on
MOE_TRAIN_MODELS = ("mixtral-8x7b", "deepseek-v2-lite")
MOE_FT_MODEL, MOE_FT_TARGETS = "deepseek-v2-lite", "wq,wo"
MOE_FT_STEPS, MOE_FT_EVERY = 6, 3
# phase 9g, Gemma 2 and 3 training: (b) full width at GEMMA_TRAIN_DEPTH
# layers (gemma2-9b two local/global groups, gemma3-12b one group of five
# local layers and a global one), batch 1 x GEMMA_TRAIN_SEQ (8192 tokens,
# so Gemma 2's 4096 window masks), the fused loss over FT_CHUNKS chunks,
# GEMMA_TRAIN_STEPS steps, held to phase 9's gradient limits; (c) a LoRA
# fine-tune of all 42 gemma2-9b layers, rank FT_RANK on all seven targets,
# batch 1 x GEMMA_FT_SEQ, GEMMA_FT_STEPS steps from phase 9f's pattern;
# (d) its adapter serving GEMMA_SERVE_TOKENS greedy tokens a request
GEMMA_TRAIN_DEPTH = {"gemma2-9b": 4, "gemma3-12b": 6}
GEMMA_TRAIN_SEQ, GEMMA_TRAIN_STEPS = 8192, 6
GEMMA_FT_SEQ, GEMMA_FT_STEPS = 4096, 6
GEMMA_SERVE_TOKENS, GEMMA_SERVE_CACHE_LEN = 32, 2048
# (d)'s registered prefix: the first tokens of its first adapter prompt
GEMMA_SERVE_PREFIX = 96
# the speculative phase: 4 drafts a step (a K = 5 verify), 256-token
# prefill chunks
SPEC_K, SPEC_CHUNK = 4, 256
# (b): where the speculative and plain bf16 engines' greedy tokens first
# differ, the plain f32 forward's top-2 margin must be below this share of
# its logits' RMS. Grounds, set before the first run: each bf16 engine's
# last-token logits sit 0.0588-0.0598 relative L2 off the f32 forward
# (PERF.md), so a top-2 margin moves by about sqrt(2) x 0.06 = 0.085 RMS
# in either engine; a flip needs the margin below that move, and 0.35 is
# four of its standard deviations. A divergence above it is not rounding.
SPEC_TIE_MARGIN = 0.35
# the HF phase: llama3-8b widths at this depth, written and loaded back
HF_LAYERS = 2
# phase 7t: the tensor-parallel engines' last-token logits against the
# one-device engine's on the same weights (relative L2). Set before the
# first run. --int4 --kv-int8 at tensor 2: every int4 product is the
# one-device engine's bytes wherever the sharded launch splits its groups
# as row 13 does (every llama3-8b shape at a 500-token chunk), the
# embedding is exact, and each shard's int8 paged kernel computes its heads
# as the one-device launch does unless its split-KV plan differs; so 0, or
# where a plan differs some bf16 roundings of attention in other places,
# well under the bf16 engine's own 0.0588 off the f32 forward: 0.05. bf16
# at tensor 4: the row-parallel products (wo, w_down) add four bf16
# partials where one GEMM rounded once, and cuBLAS picks other algorithms
# at a quarter of the widths, so every layer rounds in other places; at
# most about the bf16 engine's distance to the f32 forward: 0.1
TP_INT4_REL_L2_LIMIT = 0.05
TP_BF16_REL_L2_LIMIT = 0.1
# phase 7l: multi-LoRA on llama3-8b. Three adapters of this rank over every
# target (the fourth slot takes one registered after the burst); B drawn
# N(0, sigma^2), sigma from LORA_SIGMA0 doubling (at most to LORA_SIGMA_MAX)
# until an adapter moves the base's f32 last-token logits by 1.5 x
# LORA_MIN_MOVE (relative L2): with B zero, or a move within the engine's
# own rounding, the checks would hold for a broken delta too. (a) holds each
# adapter's logits to the engine's limit (ENGINE_REL_L2_LIMIT, or under
# --int4 --kv-int8 QUANT_ENGINE_REL_L2_LIMIT): the deltas run in bf16 like
# the base products, so they add about one more bf16 rounding a projection.
LORA_RANK, LORA_MAX_ADAPTERS = 16, 4
LORA_TARGETS_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_MIN_MOVE = 0.2
LORA_SIGMA0, LORA_SIGMA_MAX = 0.005, 0.32
# (g1)-(g3): the slots' contexts of the step graph checks (step_profile's
# decode contexts; slot 0 is moved to cross a page between the two steps)
GRAPH_LENGTHS = (402, 475, 468, 252, 411, 789, 881, 571)
# (g3): steps timed in each of the four turns
GRAPH_TIMED_STEPS = 10
# phase 3: the paged kernels at the heads of the other dense families
# (phase 7f serves them): Gemma-7B's 16 heads of 256 over 16 kv heads (GQA
# group 1), Qwen2-7B's 28 over 4 (group 7), and Mistral-7B's 4096-token
# window over contexts of 4200-5000 (table entries wholly behind the
# oldest query's window name garbage pages)
GEMMA_HEADS = {"hq": 16, "hkv": 16, "d": 256, "window": None, "cols": 128}
QWEN2_HEADS = {"hq": 28, "hkv": 4, "d": 128, "window": None, "cols": 128}
WINDOW_HEADS = {"hq": 32, "hkv": 8, "d": 128, "window": 4096, "cols": 320}
WINDOW_LENGTHS = [4200, 4311, 4452, 4580, 4699, 4777, 4901, 5000]
# phase 7f: the families served at full width and depth (bf16), those also
# served with --int4 --kv-int8, the 1024-token chunk timed on each, and
# Mistral's run past its window (cache_len 8192)
FAMILY_MODELS = ("gemma-7b", "qwen2-7b", "qwen3-8b", "mistral-7b")
FAMILY_INT4 = ("gemma-7b", "qwen2-7b")
CHUNK_TOKENS = 1024
WINDOW_PROMPT, WINDOW_DECODE = 4600, 300
# phase 3: the paged kernels at Gemma 2's heads (16 over 8 of 256) with its
# score soft cap of 50, standing for a pattern-1 config that carries a cap
# (a Gemma 2 or 3 interleave serves from the contiguous loop, whose
# attention is plain)
GEMMA2_HEADS = {"hq": 16, "hkv": 8, "d": 256, "window": None, "cols": 128,
                "soft_cap": 50.0}
# phase 7g: Gemma 2 and 3 on the contiguous loop, each through the engine
# the serve CLI builds with 1024-token chunks (rings of window + 1024):
# gemma2-9b at cache_len 8192 (ring 5120) with a prompt past its window,
# gemma3-12b at 4096 (ring 2048) in bf16 and --int4 --kv-int8, and
# llama3-8b with --prefix-cache off on a linear cache
INTERLEAVE_CHUNK = 1024
# random weights give logits of std ~1.2 (0.02 sqrt(E) through a unit final
# norm), where a final soft cap of 30 is the identity to 1e-3 and its
# control could not fail; gemma2-9b's final norm is drawn 24 higher, which
# puts the logits' std near the cap. (The score cap of 50 stays near the
# identity on random weights, scores of std ~1.4: it is held by the CPU
# parity tests and phase 3's kernel cases, and its control here rides
# with the final cap's.)
SOFTCAP_FINAL_NORM = 24.0
INTERLEAVE_RUNS = (
    # model, cache_len, quantized, long prompt, its greedy tokens (each
    # prompt alone runs past its rings of 5120 and 2048 slots; 300 and 200
    # tokens cost the whole smoke 48 s more, PERF.md §6)
    ("gemma2-9b", 8192, False, 5600, 100),
    ("gemma3-12b", 4096, False, 3000, 100),
    ("gemma3-12b", 4096, True, 3000, 100))
# phase 7g (e) and (f): gemma2-9b bf16 (7g's tree) on the contiguous loop
# with --speculate SPEC7G_K, then at --tensor-parallel TP7G in one process,
# over one traffic: prompts repeating one token SPEC7G_REPEATS times
# (drafts accepted), phase 4's first four (drafts rejected), one of
# SPEC7G_RING_PROMPT tokens past the 5120-slot ring; SPEC7G_NEW greedy
# tokens a request
SPEC7G_K = 4
TP7G = 2
SPEC7G_REPEATS = (600, 900)
SPEC7G_RING_PROMPT = 5300
SPEC7G_NEW = 24
# phase 7g (d): llama3-8b --prefix-cache off's long prompt and its greedy
# tokens, the linear decode step's logits at 1600 positions against the
# plain forward
PREFIX_OFF_LONG = (1500, 100)
# --qk-witness: the low ends of gemma3-12b's applied q/k norm draws
QK_WITNESS_LOWS = (0.5, 1.0, 1.5)
# phase 3: int4_matmul at gemma3-12b's widths (E 3840, 16/8 heads of 256,
# MLP 15360), which phase 7g's --int4 engine runs
INT4_GEMMA3_SHAPES = [(3840, 4096, "gemma3 wq"), (3840, 2048, "gemma3 wk, wv"),
                      (4096, 3840, "gemma3 wo"),
                      (3840, 15360, "gemma3 w_gate, w_up"),
                      (15360, 3840, "gemma3 w_down")]
# phase 3: int4_matmul at llama3-70b's widths (E 8192, MLP 28672)
INT4_70B_SHAPES = [(8192, 28672, "70b w_gate, w_up"),
                   (28672, 8192, "70b w_down"),
                   (8192, 128256, "70b lm_head")]
# phase 7v: DeepSeek-V2-Lite at full width and depth (E 2048, 27 layers,
# layer 0 dense at 10944, 16 heads over latent 512 + rope 64, 64 routed
# experts top-6 without renormalization and 2 shared, each of 1408, vocab
# 102400), and phase 3's kernel cases at its shapes: row 10 at its 16
# heads, row 14 at its 64 experts, row 13 at its projections (the
# prefix's w_down, 10944 in-elements, is one group: 128 does not divide
# it), rms_norm at its width and its latent's
DS_MODEL = "deepseek-v2-lite"
DS_HEADS = 16
DS_EXPERTS, DS_TOP_K, DS_WIDTH = 64, 6, 2048
INT4_DS_SHAPES = [(2048, 3072, "ds wq"), (2048, 576, "ds w_dkv"),
                  (2048, 2048, "ds wo"), (2048, 2816, "ds ws_gate, ws_up"),
                  (2816, 2048, "ds ws_down"),
                  (2048, 10944, "ds prefix w_gate, w_up"),
                  (10944, 2048, "ds prefix w_down"),
                  (2048, 102400, "ds lm_head")]
INT4_DS_EXPERT_SHAPES = [(2048, 1408, "ds we_gate, we_up"),
                         (1408, 2048, "ds we_down")]
# a page of 16 positions in each of 27 layers: 512 + 64 bf16 latents, or
# int8 latents and their two f32 scales
DS_PAGE_BYTES = {False: 27 * 16 * 576 * 2, True: 27 * 16 * (576 + 8)}
# the norm weights are drawn at U(DS_NORM_LOW, DS_NORM_LOW + 0.5): a port
# that ignored one would miss by far (the JAX init leaves them at 1)
DS_NORM_LOW = 0.75
# (c): greedy tokens of the contiguous loop against the paged loop
DS_GREEDY_TOKENS = 16


def log(msg: str) -> None:
    # a phase's header, and each lettered part's line, carries the seconds
    # since the script started, so a run's log says where its time went
    if msg.startswith(("phase ", "  (")):
        msg = f"[{time.monotonic() - T_START:.1f} s] {msg}"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out.splitlines()[0]


def kernel_name(line: str):
    """The kernel named in a ptxas line by its mangled name (a length
    prefix, the identifier, then ``I...E`` integer or bool template
    arguments), as ``name<args>``; None if no ``*_kernel`` is named."""
    for i, ch in enumerate(line):
        if not ch.isdigit():
            continue
        for j in range(i + 1, min(i + 4, len(line)) + 1):
            if not line[i:j].isdigit():
                break
            n = int(line[i:j])
            ident = line[j:j + n]
            if len(ident) == n and ident.endswith("_kernel") \
                    and (ident[0].isalpha() or ident[0] == "_"):
                targs = re.match(r"I((?:L[ib]\d+E)+)", line[j + n:])
                if targs:
                    ident += "<" + ",".join(re.findall(
                        r"L[ib](\d+)E", targs.group(1))) + ">"
                return ident
    return None


def ptxas_summary(text: str) -> list[str]:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its
    name with template arguments, registers and spill bytes."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        if "entry function" in line or "Function properties" in line:
            name = kernel_name(line) or name
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
    return out


def sass_counts(lib_path: str) -> dict:
    """Tensor-core instructions of each kernel in a built library, from
    ``cuobjdump -sass``: {kernel name: {"HGMMA": n, "HMMA": n}} (wgmma
    lowers to HGMMA, mma.sync to HMMA); {} where the toolkit that holds
    nvcc has no cuobjdump."""
    from k8s_runpod_kubelet_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out = {}
    for part in text.split("Function :")[1:]:
        head, _, body = part.partition("\n")
        name = kernel_name(head.strip())
        if name is not None:
            counts = out.setdefault(name, {"HGMMA": 0, "HMMA": 0})
            for op in counts:
                counts[op] += len(re.findall(rf"\b{op}\.", body))
    return out


def tensor_core_ok(kernel: str, counts: dict) -> bool:
    """Whether a tensor-core kernel's SASS holds what its regime needs:
    HGMMA, or for an ``int4_matmul_kernel<NR, ...>`` or
    ``int4_matmul_sharded_kernel<NR, ...>`` with NR <= INT4_DECODE_ROWS,
    HGMMA or HMMA."""
    m = re.match(r"int4_matmul(?:_sharded)?_kernel<(\d+),", kernel)
    if m and int(m.group(1)) <= INT4_DECODE_ROWS:
        return counts["HGMMA"] + counts["HMMA"] > 0
    return counts["HGMMA"] > 0


# instructions with no register destination: their first register is an
# address or a source
NO_DEST = ("ST", "RED", "ATOM", "SYNCS", "BAR", "BRA", "EXIT", "WARP", "UTMA",
           "HGMMA", "ISETP", "FSETP", "PLOP3", "VOTE", "ELECT", "NOP")
# the unpack's instructions: the q4 reads, shifts, masks, byte permutes and
# bf16x2 arithmetic (a traced register that a register reuse leaks into
# the f32 sums is not unpack work)
UNPACK_OPS = ("LDS", "SHF", "LOP3", "PRMT", "HADD2", "HFMA2", "HMUL2")


def sass_unpack_mix(lib_path: str, prefix: str) -> dict:
    """How many instructions each kernel named ``prefix<...>`` in a built
    library spends to turn its staged q4 bytes into wgmma fragments, from
    ``cuobjdump -sass``: every 16- or 32-bit shared read (LDS.U16, LDS)
    whose value reaches a byte permute (PRMT) is a q4 read, and every
    instruction whose operands descend from one (through registers, in
    program order) is unpack work. Static counts over the whole kernel: the
    q4 bytes a thread reads, the unpack instructions (``UNPACK_OPS``) by
    opcode and their ratio (every step of the loop unpacks the same way, so
    the ratio is the step loop's). {} where the toolkit has no
    cuobjdump."""
    from k8s_runpod_kubelet_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    kernels, name = {}, None
    inst = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);")
    for line in text.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :", 1)[1].strip())
            if name is not None and name.startswith(prefix + "<"):
                kernels[name] = []
            else:
                name = None
        elif name is not None:
            m = inst.search(line)
            if m:
                kernels[name].append((m.group(1), m.group(2)))
    out = {}
    for kname, code in kernels.items():
        roots, width, traced = {}, [], []
        for op, args in code:
            regs = re.findall(r"\bR(\d+)\b", args)
            if op in ("LDS", "LDS.U16"):
                width.append(4 if op == "LDS" else 2)
                src = frozenset([len(width) - 1])
                if regs:
                    roots[regs[0]] = src
                traced.append((op, src))
                continue
            if not regs or op.startswith(NO_DEST):
                continue
            src = frozenset().union(*(roots.get(r, frozenset())
                                      for r in regs[1:]))
            if src:
                roots[regs[0]] = src
                traced.append((op, src))
            else:
                roots.pop(regs[0], None)
        q4 = {r for op, src in traced if op == "PRMT" for r in src}
        ops: dict = {}
        for op, src in traced:
            if src & q4 and op.split(".")[0] in UNPACK_OPS:
                ops[op] = ops.get(op, 0) + 1
        nbytes = sum(width[r] for r in q4)
        n = sum(ops.values())
        out[kname] = {"q4_bytes": nbytes, "unpack_instructions": n,
                      "per_byte": n / nbytes if nbytes else None,
                      "ops": ops}
    return out


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median of per-launch CUDA-event times, the L2 cache flushed before
    each launch (the main path finds these inputs cold)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------------

def tolerance_check(out, ref, atol=BF16_ATOL,
                    rtol=BF16_RTOL) -> tuple[float, float]:
    """(max abs error, largest share of the tolerance) of out against ref;
    a share above 1 fails the check."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    share = (diff / (atol + rtol * ref.abs())).max().item()
    err = diff.max().item()
    return err, (share if math.isfinite(err) else math.inf)


# the heads and widths of a paged case: llama3-8b's (32 q heads over 8 kv
# heads of 128) at cache_len 2048 unless a case names another model's
LLAMA_HEADS = {"hq": 32, "hkv": 8, "d": 128, "window": None, "cols": 128}


def window_begin(lengths, kq: int, t: int, window) -> list[int]:
    """Per row, the first table entry the paged kernels read: 0, or under
    a window the page of the oldest query's first visible position (the
    entries wholly behind it are never read)."""
    if window is None:
        return [0] * len(lengths)
    return [max(0, n - kq - window + 1) // t for n in lengths]


def attention_inputs(torch, dev, b, kq, lengths, t=16, heads=None):
    """Paged attention inputs at ``heads`` (``LLAMA_HEADS`` by default):
    pages in random order, and table entries past ceil(len/T), and under
    a window those wholly behind the oldest query's window, naming pages
    of large finite garbage. ``live`` counts each row's pages the kernel
    reads."""
    heads = heads or LLAMA_HEADS
    hq, hkv, d, cols = heads["hq"], heads["hkv"], heads["d"], heads["cols"]
    # llama3-8b's cases keep the seeds they always drew from
    gen = torch.Generator().manual_seed(
        SEED + kq + (0 if heads is LLAMA_HEADS else hq + d))
    ends = [-(-n // t) for n in lengths]
    begins = window_begin(lengths, kq, t, heads["window"])
    live = [e - b0 for e, b0 in zip(ends, begins)]
    n_garbage = 64
    n_pages = sum(live) + n_garbage
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, begins[i]:ends[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        dead = torch.cat([torch.arange(begins[i]),
                          torch.arange(ends[i], cols)])
        table[i, dead] = garbage[torch.arange(len(dead)) % n_garbage].to(
            table.dtype)
    k = torch.randn((n_pages, t, hkv, d), generator=gen)
    v = torch.randn((n_pages, t, hkv, d), generator=gen)
    k[garbage] = 3e4
    v[garbage] = -3e4
    q = torch.randn((b, kq, hq, d), generator=gen)
    q, k, v = (x.to(dev, torch.bfloat16) for x in (q, k, v))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, table.to(dev), lens, live


def gathered(torch, q, k, v, table, lens, window=None):
    """q as (B, Hq, K, D), K/V gathered into contiguous (B, Hq, S, D) with
    the GQA heads repeated, and the causal mask (B, 1, K, S), under
    ``window`` the band of the last ``window`` positions."""
    b, kq, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    s_len = table.shape[1] * t
    idx = table.long()
    kc = k[idx].reshape(b, s_len, hkv, d).transpose(1, 2) \
        .repeat_interleave(hq // hkv, dim=1).contiguous()
    vc = v[idx].reshape(b, s_len, hkv, d).transpose(1, 2) \
        .repeat_interleave(hq // hkv, dim=1).contiguous()
    qs = q.transpose(1, 2).contiguous()
    qpos = (lens.long()[:, None] - kq
            + torch.arange(kq, device=q.device)[None, :])[:, None, :, None]
    kpos = torch.arange(s_len, device=q.device)[None, None, None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return qs, kc, vc, mask


def bf16_p_output(torch, s, v):
    """The textbook tensor-core kernel's P.V: unnormalised probabilities
    exp(s - rowmax) of masked scores s (-inf where masked) rounded to bf16
    before the product with v, the row sum kept in f32."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return (e.bfloat16().float() @ v.float()) / e.sum(-1, keepdim=True)


def attention_controls(torch, qs, kc, vc, mask, scale, t, ref,
                       lost_page=1, cap=None) -> dict:
    """The tolerance check applied to three broken variants of the same
    attention: p.v accumulated page by page in bf16, P rounded to bf16
    before P.V (the rounding the kernels' split of P into bf16 hi and lo
    halves avoids), and page ``lost_page`` (the second, or under a window
    one inside every row's window) lost from every context of 1024
    positions or more (rows with shorter contexts are left right, so the
    long rows alone are scored). A share of the tolerance above 1 means
    the check catches the fault."""
    b, h, kq, s_len = mask.shape[0], qs.shape[1], qs.shape[2], kc.shape[2]
    cols, d = s_len // t, qs.shape[3]
    s = (qs.float() @ kc.float().transpose(-1, -2)) * scale
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    o_bf16_p = bf16_p_output(torch, s.masked_fill(~mask, -math.inf), vc) \
        .bfloat16().transpose(1, 2)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    part = torch.einsum("bhkct,bhctd->bhkcd", p.view(b, h, kq, cols, t),
                        vc.float().view(b, h, cols, t, d))
    acc = torch.zeros_like(part[:, :, :, 0]).bfloat16()
    for c in range(cols):
        acc = (acc.float() + part[:, :, :, c]).bfloat16()
    del part
    lost = mask.clone()
    lost[..., lost_page * t:(lost_page + 1) * t] = False
    p_lost = torch.softmax(s.masked_fill(~lost, -math.inf), dim=-1)
    o_lost = (p_lost @ vc.float()).bfloat16().transpose(1, 2)
    long_rows = (mask.sum(-1) >= 1024).transpose(1, 2)[..., None]
    o_lost = torch.where(long_rows, o_lost, ref)
    out = {}
    for name, o in (("bf16_accumulation", acc.transpose(1, 2)),
                    ("bf16_p", o_bf16_p), ("lost_page", o_lost)):
        err, share = tolerance_check(o, ref)
        out[name] = {"max_abs_err": err, "tolerance_share": share}
    return out


# the four paged entry points: (wrapper name, plain name, single-token
# (q (B, Hq, D)), int8 pages)
PAGED_KINDS = {
    "paged_attention_multi": ("_paged_attention_multi_plain", False, False),
    "paged_attention_multi_quant": ("_paged_attention_multi_quant_plain",
                                    False, True),
    "paged_attention": ("_paged_attention_plain", True, False),
    "paged_attention_quant": ("_paged_attention_quant_plain", True, True),
}


def attention_case(torch, F, dev, flush, kind, name, b, kq, lengths,
                   heads=None):
    """One paged entry point against its plain version at llama3-8b's
    shapes, or at ``heads`` (another model's heads, width, table width and
    sliding window). The int8 kinds take pages that the model's own
    ``_kv_quant``
    made from the bf16 ones (the garbage pages stay large). Controls: p.v
    accumulated in bf16, P rounded to bf16 and a page lost (both kinds),
    the scales ignored and the neighbouring kv head's scales (int8 pages);
    each must read above 1x the tolerance."""
    from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
    from k8s_runpod_kubelet_tpu_torch.ops import attention

    wrapper = getattr(attention, kind)
    plain_name, single, quant = PAGED_KINDS[kind]
    plain_fn = getattr(attention, plain_name)
    heads = heads or LLAMA_HEADS
    window, cap = heads["window"], heads.get("soft_cap")
    q, k, v, table, lens, live = attention_inputs(torch, dev, b, kq, lengths,
                                                  heads=heads)
    hq, d = q.shape[2], q.shape[3]
    t, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    if quant:
        (kp, ks), (vp, vs) = _kv_quant(k), _kv_quant(v)
        pages = (kp, vp, ks, vs)
        k = kp.float() * ks[..., None]   # what the pages stand for
        v = vp.float() * vs[..., None]
    else:
        pages = (k, v)
    qa = q[:, 0].contiguous() if single else q

    def kernel():
        return wrapper(qa, *pages, table, lens, sm_scale=scale,
                       sliding_window=window, logit_soft_cap=cap)

    def plain(*pg):
        return plain_fn(qa, *(pg or pages), table, lens, sm_scale=scale,
                        sliding_window=window, logit_soft_cap=cap)

    before = wrapper.launches
    out = kernel()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{kind} did not launch its kernel")
    ref = plain()
    err, share = tolerance_check(out, ref)
    if share > 1:
        raise RuntimeError(f"{kind} {name}: max abs err {err}, {share:.2f}x "
                           f"the tolerance {TOLERANCE}")
    ref4 = ref[:, None] if single else ref
    # the library yardstick: SDPA over contiguous K/V gathered once
    qs, kc, vc, mask = gathered(torch, q, k, v, table, lens, window)
    lost_page = (1 if window is None
                 else (min(lengths) - kq) // t - 1)
    controls = attention_controls(torch, qs, kc, vc, mask, scale, t, ref4,
                                  lost_page, cap)
    if quant:
        ones = torch.ones_like(ks)
        err_s, share_s = tolerance_check(plain(kp, vp, ones, ones), ref)
        controls["scales_ignored"] = {"max_abs_err": err_s,
                                      "tolerance_share": share_s}
        # each key's scales from the neighbouring kv head: the stride-Hkv
        # indexing of the kernel's scale staging, one head off
        err_h, share_h = tolerance_check(
            plain(kp, vp, ks.roll(1, dims=2).contiguous(),
                  vs.roll(1, dims=2).contiguous()), ref)
        controls["wrong_head_scales"] = {"max_abs_err": err_h,
                                         "tolerance_share": share_h}
    for control, c in controls.items():
        if not c["tolerance_share"] > 1:
            raise RuntimeError(f"{kind} {name}: the {control} control "
                               "passed the check")
    kc, vc = kc.to(q.dtype), vc.to(q.dtype)

    def library():
        return F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                              scale=scale)

    ms = time_ms(torch, kernel, 50, flush)
    plain_ms = time_ms(torch, plain, 10, flush)
    # SDPA has no soft cap: with one it computes another function, timed
    # as a yardstick only
    yardstick_ms = time_ms(torch, library, 20, flush)
    library_ms = None if cap is not None else yardstick_ms
    page_bytes = t * hkv * d * pages[0].element_size() \
        + (t * hkv * 4 if quant else 0)
    nbytes = (2 * sum(live) * page_bytes + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    visible = sum(min(n - kq + j + 1, window or n) for n in lengths
                  for j in range(kq))
    ops = visible * hq * 4 * d          # q.k and p.v, 2 flops a product
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "B": b, "K": kq, "lengths": lengths,
           "Hq": hq, "Hkv": hkv, "D": d, "window": window, "soft_cap": cap,
           "yardstick_ms": yardstick_ms, "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    ctl = ", ".join(f"{c} {v['max_abs_err']:.3e} ({v['tolerance_share']:.2f})"
                    for c, v in controls.items())
    log(f"  {kind} {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: {ctl}) kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
        + ("library (SDPA) " if cap is None else
           "yardstick (SDPA without the soft cap) ")
        + f"{yardstick_ms:.4f} ms")
    return rec


# -- phase 3b: the MLA latent kernels ---------------------------------------------

# the four MLA entry points: (wrapper name, plain name, single-token
# (q (B, Hq, .)), int8 latents)
MLA_KINDS = {
    "paged_attention_multi_mla": ("_paged_attention_multi_mla_plain", False,
                                  False),
    "paged_attention_multi_mla_quant": (
        "_paged_attention_multi_mla_quant_plain", False, True),
    "paged_attention_mla": ("_paged_attention_mla_plain", True, False),
    "paged_attention_mla_quant": ("_paged_attention_mla_quant_plain", True,
                                  True),
}
# one decode context per slot: those of the burst's 200-900-token prompts,
# as step_profile's decode step holds them
MLA_DECODE_LENGTHS = [402, 475, 468, 252, 411, 789, 881, 571]


def mla_inputs(torch, dev, b, kq, lengths, t=16, cols=128, hq=32):
    """mla-8b shapes (32 heads, or ``hq``: DeepSeek-V2-Lite's 16; latent
    512, rope 64) at cache_len 2048: f32 absorbed queries, bf16 latent
    pages in random order, and table entries past ceil(len/T) naming pages
    of large finite garbage."""
    r, dr = 512, 64
    gen = torch.Generator().manual_seed(SEED + 7 * kq)
    live = [-(-n // t) for n in lengths]
    n_garbage = 64
    n_pages = sum(live) + n_garbage
    perm = torch.randperm(n_pages, generator=gen)
    table = torch.zeros((b, cols), dtype=torch.int32)
    used = 0
    for i in range(b):
        table[i, :live[i]] = perm[used:used + live[i]]
        used += live[i]
    garbage = perm[used:]
    for i in range(b):
        table[i, live[i]:] = garbage[torch.arange(cols - live[i]) % n_garbage]
    c = torch.randn((n_pages, t, r), generator=gen)
    kr = torch.randn((n_pages, t, dr), generator=gen)
    c[garbage] = 3e4
    kr[garbage] = -3e4
    q_lat = torch.randn((b, kq, hq, r), generator=gen)
    q_rope = torch.randn((b, kq, hq, dr), generator=gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q_lat.to(dev), q_rope.to(dev), c.to(dev, torch.bfloat16),
            kr.to(dev, torch.bfloat16), table.to(dev), lens, live)


def mla_variant(torch, q_lat, q_rope, c, kr, lens, scale, drop_rope=False,
                lost_page=False, causal=True, q_bf16=False):
    """The absorbed attention written out over gathered f32 latents c
    (B, S, R) and kr (B, S, Dr), with one fault switched on for a control:
    the rope term dropped, the second page (positions 16-31) lost, the
    causal floor off (every query sees the whole context), or the scaled
    queries rounded to bf16 alone (a tensor-core product without the lo
    term of the kernels' hi + lo split)."""
    kq, s_len = q_lat.shape[1], c.shape[1]
    ql, qr = q_lat * scale, q_rope * scale
    if q_bf16:
        ql, qr = ql.bfloat16().float(), qr.bfloat16().float()
    s = torch.einsum("bkhr,bLr->bkhL", ql, c)
    if not drop_rope:
        s = s + torch.einsum("bkhd,bLd->bkhL", qr, kr)
    pos = torch.arange(s_len, device=c.device)
    if causal:
        qpos = (lens.long()[:, None] - kq
                + torch.arange(kq, device=c.device)[None, :])
        valid = pos[None, None, :] <= qpos[:, :, None]          # (B, K, S)
    else:
        valid = (pos[None, :] < lens.long()[:, None])[:, None, :] \
            .expand(-1, kq, -1)
    if lost_page:
        valid = valid & ((pos < 16) | (pos >= 32))
    p = torch.softmax(s.masked_fill(~valid[:, :, None], -math.inf), dim=-1)
    return torch.einsum("bkhL,bLr->bkhr", p, c)


def mla_case(torch, F, dev, flush, kind, name, b, kq, lengths, hq=32):
    """One MLA entry point against its plain version at mla-8b's shapes
    (``hq`` 16: DeepSeek-V2-Lite's heads). The
    int8 kinds take latents that the model's own ``_kv_quant`` made from the
    bf16 ones (the garbage pages stay large). Controls, each scored by the
    same check and each required above 1x: the rope term dropped, a page
    lost, the causal floor off (K > 1), q in bf16 alone (no lo term), the
    scales ignored (int8)."""
    from k8s_runpod_kubelet_tpu_torch.models.llama import _kv_quant
    from k8s_runpod_kubelet_tpu_torch.ops import attention

    wrapper = getattr(attention, kind)
    plain_name, single, quant = MLA_KINDS[kind]
    plain_fn = getattr(attention, plain_name)
    q_lat, q_rope, c, kr, table, lens, live = mla_inputs(torch, dev, b, kq,
                                                         lengths, hq=hq)
    r = q_lat.shape[3]
    t, dr = kr.shape[1], kr.shape[2]
    scale = (128 + dr) ** -0.5           # mla-8b: (head_dim + rope)^-0.5
    if quant:
        (cp, cs), (krp, krs) = _kv_quant(c), _kv_quant(kr)
        pages = (cp, krp, cs, krs)
        c = cp.float() * cs[..., None]   # what the pages stand for
        kr = krp.float() * krs[..., None]
    else:
        pages = (c, kr)
    qa = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous()) if single \
        else (q_lat, q_rope)

    def kernel():
        return wrapper(*qa, *pages, table, lens, sm_scale=scale)

    def plain(*pg):
        return plain_fn(*qa, *(pg or pages), table, lens, sm_scale=scale)

    before = wrapper.launches
    out = kernel()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{kind} did not launch its kernel")
    ref = plain()
    err, share = tolerance_check(out, ref)
    if share > 1:
        raise RuntimeError(f"{kind} {name}: max abs err {err}, {share:.2f}x "
                           f"the tolerance {TOLERANCE}")
    ref4 = ref[:, None] if single else ref
    idx = table.long()
    cg = c[idx].float().reshape(b, -1, r)
    krg = kr[idx].float().reshape(b, -1, dr)
    variants = {"rope_dropped": dict(drop_rope=True),
                "lost_page": dict(lost_page=True),
                "q_bf16": dict(q_bf16=True)}
    if kq > 1:
        variants["causal_floor_off"] = dict(causal=False)
    controls = {}
    for control, kw in variants.items():
        o = mla_variant(torch, q_lat, q_rope, cg, krg, lens, scale, **kw)
        e, sh = tolerance_check(o, ref4)
        controls[control] = {"max_abs_err": e, "tolerance_share": sh}
        del o
    if quant:
        ones = torch.ones_like(pages[2])
        e, sh = tolerance_check(plain(pages[0], pages[1], ones, ones), ref)
        controls["scales_ignored"] = {"max_abs_err": e, "tolerance_share": sh}
    for control, ctl in controls.items():
        if not ctl["tolerance_share"] > 1:
            raise RuntimeError(f"{kind} {name}: the {control} control "
                               "passed the check")
    # the library yardstick: SDPA over the gathered (dequantized) latents in
    # bf16, q = [q_lat, q_rope], k = [c, kr] and v = c as one kv head
    s_len = cg.shape[1]
    qs = torch.cat([q_lat, q_rope], -1).transpose(1, 2).bfloat16()
    ks = torch.cat([cg, krg], -1)[:, None].bfloat16()
    vs = cg[:, None].bfloat16()
    qpos = (lens.long()[:, None] - kq
            + torch.arange(kq, device=dev)[None, :])[:, None, :, None]
    mask = torch.arange(s_len, device=dev)[None, None, None, :] <= qpos
    del cg, krg

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    ms = time_ms(torch, kernel, 50, flush)
    plain_ms = time_ms(torch, plain, 10, flush)
    library_ms = time_ms(torch, library, 20, flush)
    page_bytes = t * (r + dr) * pages[0].element_size() \
        + (2 * t * 4 if quant else 0)
    nbytes = (sum(live) * page_bytes + q_lat.numel() * 4
              + q_rope.numel() * 4 + q_lat.numel() * 4 + table.numel() * 4
              + lens.numel() * 4)
    visible = sum(n - kq + j + 1 for n in lengths for j in range(kq))
    ops = visible * hq * (2 * (r + dr) + 2 * r)   # scores and p.c
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "B": b, "K": kq, "lengths": lengths,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    ctl = ", ".join(f"{c_} {v['tolerance_share']:.1f}"
                    for c_, v in controls.items())
    log(f"  {kind} {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: {ctl}) kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, library "
        f"(SDPA yardstick) {library_ms:.4f} ms")
    return rec


# the distinct projection shapes of llama3-8b: (in, out, leaves)
INT4_SHAPES = [(4096, 4096, "wq, wo"), (4096, 1024, "wk, wv"),
               (4096, 14336, "w_gate, w_up"), (14336, 4096, "w_down"),
               (4096, 128256, "lm_head")]


def int4_plain_rows(torch, h, q4, scale):
    """``_int4_matmul_plain`` applied to row blocks whose (rows, groups,
    out) f32 partials stay under 1 GiB (rows are independent; the plain
    version materializes that tensor: 16 GiB at 1024 rows of the head)."""
    from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import \
        _int4_matmul_plain

    per_row = scale.shape[0] * q4.shape[1] * 4
    step = max(1, 2**30 // per_row)
    return torch.cat([_int4_matmul_plain(h[r:r + step], q4, scale)
                      for r in range(0, h.shape[0], step)])


# the library's int4 GEMM against the plain version: it takes the scales in
# bf16 (2^-9 relative) and dequantizes each weight to bf16 before its f32
# sums, so it is held by the relative L2 norm of its difference, not per
# element
INT4PACK_REL_L2_LIMIT = 1e-2


def int4pack_call(torch, h, q4, scale):
    """``torch.ops.aten._weight_int4pack_mm`` set up for the port's packed
    weight: the same nibbles (q - 8 with q stored + 8), repacked to the
    library's (out, in/2) bytes with the even in-element in the high nibble
    and tiled by ``_convert_weight_to_int4pack``, the group scales in bf16
    beside zero points of 0. A group the library does not take (one group
    of 10944, DeepSeek's prefix w_down) is split into the largest group
    it takes that divides it, each part with the same scale: the same
    function. Returns the call."""
    kin2, out = q4.shape
    group = 2 * kin2 // scale.shape[0]
    if group not in (32, 64, 128, 256):
        part = next(g for g in (256, 128, 64, 32) if group % g == 0)
        scale = scale.repeat_interleave(group // part, dim=0)
        group = part
    nib = ((q4 & 0xF) << 4) | (q4 >> 4)
    # the library tiles the contraction by 16 x inner_k_tiles (8 where it
    # divides, as at every width but DeepSeek's 10944)
    inner = next(t for t in (8, 4, 2) if (2 * kin2) % (16 * t) == 0)
    packed = torch.ops.aten._convert_weight_to_int4pack(
        nib.t().contiguous(), inner)
    sz = torch.stack([scale[:, 0, :], torch.zeros_like(scale[:, 0, :])],
                     dim=-1).bfloat16().contiguous()
    return lambda: torch.ops.aten._weight_int4pack_mm(h, packed, group, sz)


def int4_case(torch, dev, flush, rows, kin, out, leaves):
    """``int4_matmul`` at one projection shape against its plain version:
    random weights (normal * 0.02) quantized by the port's quantizer on the
    card, bf16 activations. Controls, scored by the same check: the two
    nibbles of every byte swapped, each group given its neighbour's scale,
    and the scale folded into bf16 weights before the product (the
    dequantized bf16 weight in an f32 product). Times: the kernel, the
    plain version (row blocks, see ``int4_plain_rows``), the library's int4
    GEMM
    ``_weight_int4pack_mm`` on the same nibbles and group scales (the same
    function up to the scales' bf16 rounding; its output is held against
    the plain version by relative L2, ``INT4PACK_REL_L2_LIMIT``) and, as a
    yardstick the port never calls, ``torch.matmul`` of h by the
    dequantized bf16 weight (cuBLAS, 4x the weight bytes)."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import (
        _quantize_leaf_int4, dequantize)
    from k8s_runpod_kubelet_tpu_torch.ops import int4_matmul

    gen = torch.Generator(device=dev).manual_seed(SEED + kin + out)
    w = torch.randn((kin, out), generator=gen, device=dev) * 0.02
    leaf = _quantize_leaf_int4(w)
    del w
    q4, scale = leaf["q4"], leaf["scale"]
    h = torch.randn((rows, kin), generator=gen, device=dev).bfloat16()
    name = f"{rows} x ({kin} -> {out}) [{leaves}]"
    before = int4_matmul.launches
    y = int4_matmul(h, q4, scale)
    torch.cuda.synchronize()
    if int4_matmul.launches != before + 1:
        raise RuntimeError("int4_matmul did not launch its kernel")
    hf = h.float()
    ref = int4_plain_rows(torch, hf, q4, scale)   # f32, before its cast
    err, share = tolerance_check(y, ref)
    if share > 1:
        raise RuntimeError(f"int4_matmul {name}: max abs err {err}, "
                           f"{share:.2f}x the tolerance {TOLERANCE}")
    swapped = (q4 >> 4) | (q4 << 4)
    w_bf16 = dequantize(leaf).bfloat16()
    controls = {}
    # each group given its neighbour's scales; with one group (DeepSeek's
    # prefix w_down) each column its neighbour's
    roll_dim = 0 if scale.shape[0] > 1 else -1
    for control, fn in (
            ("nibbles_swapped",
             lambda: int4_plain_rows(torch, hf, swapped, scale)),
            ("neighbour_group_scale",
             lambda: int4_plain_rows(torch, hf, q4,
                                     torch.roll(scale, 1, dims=roll_dim))),
            # the scale folded into bf16 weights before an f32 product
            ("scale_folded_bf16", lambda: hf @ w_bf16.float())):
        e, sh = tolerance_check(fn(), ref)
        controls[control] = {"max_abs_err": e, "tolerance_share": sh}
        if not sh > 1:
            raise RuntimeError(f"int4_matmul {name}: the {control} control "
                               "passed the check")
    int4pack = int4pack_call(torch, h, q4, scale)
    lib_y = int4pack()
    lib_err, lib_share = tolerance_check(lib_y, ref)
    rel = ((lib_y.float() - ref).norm() / ref.norm()).item()
    int4pack_check = {"max_abs_err": lib_err, "tolerance_share": lib_share,
                      "rel_l2": rel, "limit": INT4PACK_REL_L2_LIMIT}
    if not rel <= INT4PACK_REL_L2_LIMIT:
        raise RuntimeError(f"_weight_int4pack_mm {name}: relative L2 {rel} "
                           "from the plain version")
    del ref, swapped, hf, lib_y
    big = rows * kin * out > 2**34
    ms = time_ms(torch, lambda: int4_matmul(h, q4, scale), 5 if big else 30,
                 flush)
    plain_ms = time_ms(torch, lambda: int4_plain_rows(torch, h, q4, scale),
                       2 if big else 5, flush)
    library_ms = time_ms(torch, int4pack, 20, flush)
    yardstick_ms = time_ms(torch, lambda: torch.matmul(h, w_bf16), 20, flush)
    nbytes = q4.numel() + scale.numel() * 4 + h.numel() * 2 + rows * out * 2
    ops = 2 * rows * kin * out
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "rows": rows, "in": kin, "out": out,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "int4pack_check": int4pack_check, "yardstick_ms": yardstick_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "tflops": ops / ms / 1e9,
           "gb_per_s": nbytes / ms / 1e6}
    log(f"  int4_matmul {name}: max_abs_err {err:.3e} ({share:.2f} of "
        f"{TOLERANCE}; controls: nibbles swapped "
        f"{controls['nibbles_swapped']['tolerance_share']:.0f}, neighbour "
        f"group's scale "
        f"{controls['neighbour_group_scale']['tolerance_share']:.0f}, scale "
        f"folded into bf16 weights "
        f"{controls['scale_folded_bf16']['tolerance_share']:.1f}) kernel "
        f"{ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s, {rec['gb_per_s']:.0f} "
        f"GB/s), bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} "
        f"ms, library (_weight_int4pack_mm) {library_ms:.4f} ms (relative L2 "
        f"{rel:.2e}, per element {lib_share:.2f} of the tolerance), "
        f"yardstick (matmul by the dequantized bf16 weight) "
        f"{yardstick_ms:.4f} ms")
    return rec


# llama3-8b's projections out-sharded over a tensor mesh, a shard's slice:
# (in, out a shard, leaves) at each degree
INT4_SHARDED_SHAPES = {
    n: [(4096, 4096 // n, "wq, wo"), (4096, 1024 // n, "wk, wv"),
        (4096, 14336 // n, "w_gate, w_up"), (14336, 4096 // n, "w_down"),
        (4096, 128256 // n, "lm_head")] for n in (2, 4)}


def int4_sharded_case(torch, dev, flush, rows, shards, kin, out, leaves):
    """``int4_matmul_sharded`` (row 15) at one shard's projection shape on
    an in-process tensor mesh: a random (in, N * out) weight quantized by
    the port's quantizer, its N out-slices stacked, bf16 activations; one
    launch for every shard against the plain version (each shard's
    ``int4_plain_rows``, gathered), with row 13's tolerance; a broken
    control (every shard's columns written into its neighbour's block)
    that must miss; row 13 on the gathered weight, which must give the
    same bytes where both launches split the groups alike. Times: the
    kernel; the plain version; the library's int4 GEMM on the gathered
    weight (one ``_weight_int4pack_mm``, the same function); as yardsticks
    ``_weight_int4pack_mm`` once a shard, row 13 on the gathered weight,
    and row 13 on one shard's slice (what one rank of an N-card
    deployment launches)."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  int4_matmul_sharded)
    from k8s_runpod_kubelet_tpu_torch.ops.int4_matmul import (
        _launchers, _sharded_launchers)
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(tensor=shards))
    gen = torch.Generator(device=dev).manual_seed(SEED + kin + out + shards)
    w = torch.randn((kin, shards * out), generator=gen, device=dev) * 0.02
    leaf = _quantize_leaf_int4(w)
    del w
    q4_all, scale_all = leaf["q4"], leaf["scale"]
    q4 = q4_all.unflatten(1, (shards, out)).movedim(1, 0).contiguous()
    scale = scale_all.unflatten(2, (shards, out)).movedim(2, 0).contiguous()
    h = torch.randn((rows, kin), generator=gen, device=dev).bfloat16()
    name = f"{rows} x ({kin} -> {shards} x {out}) [{leaves}]"
    before = (int4_matmul.launches, int4_matmul_sharded.launches)
    y = int4_matmul_sharded(h, q4, scale, mesh)
    torch.cuda.synchronize()
    if (int4_matmul.launches, int4_matmul_sharded.launches) != \
            (before[0], before[1] + 1):
        raise RuntimeError("int4_matmul_sharded did not launch its kernel "
                           "once")
    hf = h.float()
    ref = torch.cat([int4_plain_rows(torch, hf, q4[s], scale[s])
                     for s in range(shards)], dim=1)
    err, share = tolerance_check(y, ref)
    if share > 1:
        raise RuntimeError(f"int4_matmul_sharded {name}: max abs err {err}, "
                           f"{share:.2f}x the tolerance {TOLERANCE}")
    rolled = y.view(rows, shards, out).roll(1, dims=1).reshape(rows, -1)
    _, control_share = tolerance_check(rolled, ref)
    if not control_share > 1:
        raise RuntimeError(f"int4_matmul_sharded {name}: the control with "
                           "the shards' blocks swapped passed the check")
    del rolled, hf
    g = scale.shape[1]
    splits = _sharded_launchers()[1](shards, rows, out, g)
    splits_13 = _launchers()[1](rows, shards * out, g)
    y13 = int4_matmul(h, q4_all, scale_all)
    same_bytes = bool(torch.equal(y, y13))
    if splits == splits_13 and not same_bytes:
        raise RuntimeError(f"int4_matmul_sharded {name}: split {splits} "
                           "ways as row 13 on the gathered weight, yet "
                           "other bytes")
    why = ("" if splits == splits_13 else
           f"; row 13 splits the groups {splits_13} ways over "
           f"{-(-(shards * out) // 128)} column tiles, this launch "
           f"{splits} ways over {shards} x {-(-out // 128)}: f32 sums in "
           "another order")
    del ref, y13
    big = rows * kin * out * shards > 2**34
    ms = time_ms(torch, lambda: int4_matmul_sharded(h, q4, scale, mesh),
                 5 if big else 30, flush)
    plain_ms = time_ms(torch, lambda: torch.cat(
        [int4_plain_rows(torch, h, q4[s], scale[s]) for s in range(shards)],
        dim=1), 2 if big else 5, flush)
    library_ms = time_ms(torch, int4pack_call(torch, h, q4_all, scale_all),
                         20, flush)
    per_shard = [int4pack_call(torch, h, q4[s], scale[s])
                 for s in range(shards)]
    per_shard_ms = time_ms(torch, lambda: [c() for c in per_shard], 20,
                           flush)
    gathered_ms = time_ms(torch, lambda: int4_matmul(h, q4_all, scale_all),
                          5 if big else 30, flush)
    q40, scale0 = q4[0].contiguous(), scale[0].contiguous()
    rank_ms = time_ms(torch, lambda: int4_matmul(h, q40, scale0),
                      5 if big else 30, flush)
    nbytes = q4.numel() + scale.numel() * 4 + h.numel() * 2 \
        + rows * shards * out * 2
    ops = 2 * rows * kin * out * shards
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "rows": rows, "shards": shards, "in": kin,
           "out_per_shard": out, "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share,
           "controls": {"blocks_swapped": {"tolerance_share": control_share}},
           "splits": splits, "row13_splits": splits_13,
           "same_bytes_as_row13": same_bytes, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "int4pack_per_shard_ms": per_shard_ms,
           "row13_gathered_ms": gathered_ms, "row13_one_shard_ms": rank_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "tflops": ops / ms / 1e9,
           "gb_per_s": nbytes / ms / 1e6}
    log(f"  int4_matmul_sharded {name}: max_abs_err {err:.3e} ({share:.2f} "
        f"of {TOLERANCE}; control, shards' blocks swapped "
        f"{control_share:.0f}); row 13 on the gathered weight: same bytes "
        f"{same_bytes}{why}; kernel {ms:.4f} ms ({rec['tflops']:.1f} "
        f"TFLOP/s, {rec['gb_per_s']:.0f} GB/s), bound {bound_ms:.4f} ms "
        f"({bound_by}), plain {plain_ms:.3f} ms, library "
        f"(_weight_int4pack_mm, gathered weight) {library_ms:.4f} ms; "
        f"yardsticks: _weight_int4pack_mm a shard {per_shard_ms:.4f} ms, "
        f"row 13 gathered {gathered_ms:.4f} ms, row 13 on one shard's "
        f"slice {rank_ms:.4f} ms")
    return rec


# the expert projections of mixtral-8x7b: (in, out, leaves), 8 experts,
# top-2; and the expert buffer's rows C at each path: a decode step of 8
# slots, a K = 5 verify step of 8 slots, a 1024-token prefill chunk (the
# serving capacity is every token: C = G)
INT4_EXPERT_SHAPES = [(4096, 14336, "we_gate, we_up"),
                      (14336, 4096, "we_down")]
MOE_EXPERTS, MOE_TOP_K = 8, 2
INT4_EXPERT_ROWS = ((8, "decode"), (40, "verify K=5"), (1024, "prefill"))


def expert_counts(torch, dev, tokens: int, experts: int = MOE_EXPERTS,
                  top_k: int = MOE_TOP_K, width: int = 4096
                  ) -> "torch.Tensor":
    """Filled rows per expert when ``tokens`` tokens each pick their top
    ``top_k`` of ``experts`` experts (Mixtral's 2 of 8 by default) under a
    seeded router (f32 logits of seeded normal hidden states of ``width``
    through a seeded normal router): (experts,) int32 on the card."""
    gen = torch.Generator(device=dev).manual_seed(SEED + tokens)
    h = torch.randn((tokens, width), generator=gen, device=dev)
    router = torch.randn((width, experts), generator=gen,
                         device=dev) * 0.02
    top = torch.topk(torch.softmax(h @ router, dim=-1), top_k).indices
    return torch.bincount(top.flatten(), minlength=experts).to(torch.int32)


def int4_expert_inputs(torch, dev, rows, kin, out, experts=MOE_EXPERTS,
                       top_k=MOE_TOP_K, width=4096):
    """One projection's inputs for ``int4_expert_matmul`` at a buffer of
    ``rows`` rows an expert: ``experts`` experts of random weights (normal
    * 0.02) quantized by the port's quantizer on the card, the counts of a
    seeded top-``top_k`` router over ``rows`` tokens, and the buffer's
    first count rows of each expert filled with bf16 values, the rest zero
    (as the MoE dispatch leaves them): (h, q4, scale, counts, filled)."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import _quantize_leaf_int4

    gen = torch.Generator(device=dev).manual_seed(SEED + kin + out)
    leaves_q = []
    for _ in range(experts):
        w = torch.randn((kin, out), generator=gen, device=dev) * 0.02
        leaves_q.append(_quantize_leaf_int4(w))
        del w
    q4 = torch.stack([lq["q4"] for lq in leaves_q])
    scale = torch.stack([lq["scale"] for lq in leaves_q])
    del leaves_q
    counts = expert_counts(torch, dev, rows, experts, top_k, width)
    filled = (torch.arange(rows, device=dev)[None, :]
              < counts[:, None].long())                      # (X, C)
    h = (torch.randn((experts, rows, kin), generator=gen, device=dev)
         * filled[..., None]).bfloat16()
    return h, q4, scale, counts, filled


def int4_expert_case(torch, dev, flush, rows, path, kin, out, leaves,
                     experts=MOE_EXPERTS, top_k=MOE_TOP_K, width=4096):
    """``int4_expert_matmul`` at one expert projection of mixtral-8x7b (or
    of DeepSeek-V2-Lite: ``experts`` 64, ``top_k`` 6, ``width`` 2048) and
    one path's buffer of ``rows`` rows an expert: 8 experts of random
    weights (normal * 0.02) quantized by the port's quantizer on the card,
    the buffer's first count rows of each expert filled with bf16 values
    and the rest zero (as the MoE dispatch leaves them), the counts from a
    seeded top-2 router over ``rows`` tokens. Checked against the plain
    version per element on every row; rows past a count must be exactly
    zero, and the launch at full capacity (no counts) must give the same
    bytes. Controls, scored by the same check: the two nibbles of each
    byte swapped, each expert given its neighbour's weights (an expert
    stride off by one), each group given its neighbour's scale. Times: the
    kernel with the counts and at full capacity, the plain version, and as
    a yardstick the port never calls, ``torch.bmm`` by the dequantized
    bf16 experts. The bound counts what these counts need: the weights of
    the experts that hold a row, the filled rows' operations."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import dequantize
    from k8s_runpod_kubelet_tpu_torch.ops import int4_expert_matmul

    h, q4, scale, counts, filled = int4_expert_inputs(
        torch, dev, rows, kin, out, experts, top_k, width)
    name = f"{path}: {experts} x {rows} x ({kin} -> {out}) [{leaves}]"
    before = int4_expert_matmul.launches
    y = int4_expert_matmul(h, q4, scale, counts)
    y_full = int4_expert_matmul(h, q4, scale)
    torch.cuda.synchronize()
    if int4_expert_matmul.launches != before + 2:
        raise RuntimeError("int4_expert_matmul did not launch its kernel")
    def plain(q, sc):
        return torch.stack([int4_plain_rows(torch, h[x].float(), q[x], sc[x])
                            for x in range(experts)])

    ref = plain(q4, scale)                       # f32, before its cast
    err, share = tolerance_check(y, ref)
    if share > 1:
        raise RuntimeError(f"int4_expert_matmul {name}: max abs err {err}, "
                           f"{share:.2f}x the tolerance {TOLERANCE}")
    past = y[~filled]
    if past.numel() and past.abs().max().item() != 0:
        raise RuntimeError(f"int4_expert_matmul {name}: rows past a count "
                           "are not zero")
    if not torch.equal(y, y_full):
        raise RuntimeError(f"int4_expert_matmul {name}: the launch with "
                           "counts differs from the one at full capacity")
    controls = {}
    for control, fn in (
            ("nibbles_swapped", lambda: plain((q4 >> 4) | (q4 << 4), scale)),
            ("neighbour_expert", lambda: plain(torch.roll(q4, 1, dims=0),
                                               torch.roll(scale, 1, dims=0))),
            ("neighbour_group_scale",
             lambda: plain(q4, torch.roll(scale, 1, dims=1)))):
        e, sh = tolerance_check(fn(), ref)
        controls[control] = {"max_abs_err": e, "tolerance_share": sh}
        if not sh > 1:
            raise RuntimeError(f"int4_expert_matmul {name}: the {control} "
                               "control passed the check")
    del ref
    w_bf16 = dequantize({"q4": q4, "scale": scale}).bfloat16()
    big = rows >= 1024
    ms = time_ms(torch, lambda: int4_expert_matmul(h, q4, scale, counts),
                 10 if big else 30, flush)
    full_ms = time_ms(torch, lambda: int4_expert_matmul(h, q4, scale),
                      10 if big else 30, flush)
    plain_ms = time_ms(torch, lambda: plain(q4, scale), 2 if big else 5,
                       flush)
    yardstick_ms = time_ms(torch, lambda: torch.bmm(h, w_bf16), 10, flush)
    del w_bf16
    used = int((counts > 0).sum())
    filled_rows = int(counts.sum())
    per_expert = q4[0].numel() + scale[0].numel() * 4
    nbytes = (used * per_expert + filled_rows * kin * 2
              + experts * rows * out * 2)
    ops = 2 * filled_rows * kin * out
    bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
    rec = {"case": name, "rows": rows, "in": kin, "out": out,
           "counts": counts.tolist(), "experts_used": used,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share, "controls": controls, "ms": ms,
           "full_capacity_ms": full_ms, "plain_ms": plain_ms,
           "library_ms": None, "yardstick_ms": yardstick_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "tflops": ops / ms / 1e9,
           "gb_per_s": nbytes / ms / 1e6}
    log(f"  int4_expert_matmul {name}: counts {counts.tolist()}; max_abs_err "
        f"{err:.3e} ({share:.2f} of {TOLERANCE}), rows past the counts "
        f"exactly 0; controls: nibbles swapped "
        f"{controls['nibbles_swapped']['tolerance_share']:.0f}, neighbour "
        f"expert {controls['neighbour_expert']['tolerance_share']:.0f}, "
        f"neighbour group's scale "
        f"{controls['neighbour_group_scale']['tolerance_share']:.0f}; kernel "
        f"{ms:.4f} ms with counts ({rec['tflops']:.1f} TFLOP/s, "
        f"{rec['gb_per_s']:.0f} GB/s), {full_ms:.4f} ms at full capacity, "
        f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms, "
        f"yardstick (torch.bmm by the dequantized bf16 experts) "
        f"{yardstick_ms:.4f} ms")
    return rec


def rms_case(torch, F, dev, flush, shape, grad=False, control=False):
    """``rms_norm`` on x of ``shape`` (last axis 4096) against its plain
    version. With ``grad`` x and the f32 weight need gradients, as on the
    training path: the call goes through the autograd Function, and y, dx
    and dw are each held against autograd of the plain version; with
    ``control`` (phase 9g (a)) a broken dx, g w / rms(x) without the term
    through the mean square, must miss the same check."""
    from k8s_runpod_kubelet_tpu_torch.ops import rms_norm
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

    e, eps = shape[-1], 1e-5
    rows = math.prod(shape[:-1])
    gen = torch.Generator().manual_seed(SEED + rows)
    x = torch.randn(shape, generator=gen).mul_(3).to(dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn((e,), generator=gen)).to(dev)
    w_bf16 = w.to(torch.bfloat16)   # the library call takes one dtype
    name = (f"rows={rows}" + (f" E={e}" if e != 4096 else "")
            + (" (train, with gradients)" if grad else ""))
    x.requires_grad_(grad)
    w.requires_grad_(grad)

    before = rms_norm.launches
    out = rms_norm(x, w, eps)
    torch.cuda.synchronize()
    if rms_norm.launches != before + 1:
        raise RuntimeError("rms_norm did not launch its kernel")
    px, pw = (t.detach().clone().requires_grad_(grad) for t in (x, w))
    ref = _rms_norm_plain(px, pw, eps)
    checks = {"y": tolerance_check(out, ref)}
    if grad:
        g = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        dx, dw = torch.autograd.grad(out, (x, w), g)
        pdx, pdw = torch.autograd.grad(ref, (px, pw), g)
        if dx.dtype != x.dtype or dw.dtype != torch.float32:
            raise RuntimeError(f"rms_norm gradients came as {dx.dtype}, "
                               f"{dw.dtype}")
        checks.update(dx=tolerance_check(dx, pdx), dw=tolerance_check(dw, pdw))
        ctl = None
        if control:
            xf = x.detach().float()
            rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            ctl = tolerance_check(g.float() * w.detach() * rstd, pdx)
            del xf, rstd
            if not ctl[1] > 1:
                raise RuntimeError(f"rms_norm {name}: the control (dx without "
                                   f"the mean square's term) passed: {ctl}")
        del g, dx, dw, pdx, pdw
    del px, pw, ref
    for what, (err, share) in checks.items():
        if share > 1:
            raise RuntimeError(f"rms_norm {name} {what}: max abs err {err}, "
                               f"{share:.2f}x the tolerance {TOLERANCE}")
    err = max(e_ for e_, _ in checks.values())
    share = max(s_ for _, s_ in checks.values())
    ms = time_ms(torch, lambda: rms_norm(x, w, eps), 100, flush)
    with torch.no_grad():
        plain_ms = time_ms(torch, lambda: _rms_norm_plain(x, w, eps), 50,
                           flush)
        library_ms = time_ms(torch, lambda: F.rms_norm(x, (e,), w_bf16,
                                                       eps), 100, flush)
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    ops = 4 * x.numel()   # square, sum, scale, weight: f32 elementwise
    bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
    rec = {"case": name, "rows": rows, "E": e, "grad": grad,
           "max_abs_err": err, "tolerance": TOLERANCE,
           "tolerance_share": share,
           "checks": {k: {"max_abs_err": v[0], "tolerance_share": v[1]}
                      for k, v in checks.items()},
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops}
    shares = ", ".join(f"{k} {v[1]:.2f}" for k, v in checks.items())
    if grad and control:
        rec["control_dx_without_mean_square_term"] = {
            "max_abs_err": ctl[0], "tolerance_share": ctl[1]}
        shares += f"; control {ctl[1]:.1f}"
    log(f"  rms_norm {name}: max_abs_err {err:.3e} (of {TOLERANCE}: "
        f"{shares}) kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), plain {plain_ms:.4f} ms, library (F.rms_norm) "
        f"{library_ms:.4f} ms")
    return rec


# -- phase 8: the flash attention kernels -------------------------------------------

# a capped case's second draw, q at LARGE_Q times the first: the scores'
# sigma 8, their largest near the cap of 50, where tanh bends them. There
# each of o, dq, dk and dv is held to LARGE_Q_REL_L2 relative L2 off its
# plain version (bf16 output rounding reads 1.66e-3 in each; PERF.md
# §6) and every element within the per-element check, and the cap left
# out of the backward must exceed the relative L2 limit in each of dq, dk
# and dv (the dK/dV kernel's per-element misses here, summed straight in
# the wgmma accumulator, closed by csrc/flash_attention.cu's tile sum
# (FLASH_DKV_STRAIGHT); ``workloads/flash_large_logits.py`` reads dK against
# float64)
LARGE_Q, LARGE_Q_REL_L2 = 8.0, 4e-3

FLASH_CASES = [
    # name, B, Hq, Hkv, S, D, causal, window, soft cap
    ("train B=8 S=2048 D=128", 8, 32, 8, 2048, 128, True, None, None),
    ("ragged S=1000", 2, 32, 8, 1000, 128, True, None, None),
    ("D=64", 4, 16, 4, 1024, 64, True, None, None),
    ("D=256", 2, 8, 4, 1024, 256, True, None, None),
    ("GQA group 1", 2, 16, 16, 1024, 128, True, None, None),
    ("window 512", 2, 32, 8, 2048, 128, True, 512, None),
    ("soft cap 5", 2, 32, 8, 1024, 128, True, None, 5.0),
    ("non-causal", 2, 32, 8, 1024, 128, False, None, None),
    # the serving shapes: a dense-route prefill head (max_prefill_len
    # 1024) and an embed of a ragged length, one sequence each
    ("serving B=1 S=1024", 1, 32, 8, 1024, 128, True, None, None),
    ("serving B=1 S=1000", 1, 32, 8, 1000, 128, True, None, None),
    # MLA's direct form at mla-8b's widths: q/k at head_dim 128 + rope 64,
    # one kv head a q head, v zero-padded to 192; the train phase's shape
    # and a dense-route prefill head
    ("MLA train B=8 S=2048 D=192", 8, 32, 32, 2048, 192, True, None, None),
    ("MLA serving B=1 S=1024 D=192", 1, 32, 32, 1024, 192, True, None,
     None),
    # DeepSeek-V2-Lite's dense-route prefill head: 16 heads at D = 192
    ("DeepSeek serving B=1 S=1024 D=192 16 heads", 1, 16, 16, 1024, 192,
     True, None, None),
    # Gemma-7B's dense-route prefill head: 16 heads of 256, GQA group 1
    ("Gemma serving B=1 S=1024 D=256 group 1", 1, 16, 16, 1024, 256, True,
     None, None),
    # Gemma 2's prefill heads (16 over 8 of 256, soft cap 50): a global
    # layer's, and a local layer's past its 4096-token window; Gemma 3's
    # local layer under its 1024-token window (phase 7g)
    ("Gemma 2 global B=1 S=1024 D=256 soft cap 50", 1, 16, 8, 1024, 256,
     True, None, 50.0),
    ("Gemma 2 local B=1 S=6144 D=256 window 4096 soft cap 50", 1, 16, 8,
     6144, 256, True, 4096, 50.0),
    ("Gemma 3 local B=1 S=2048 D=256 window 1024", 1, 16, 8, 2048, 256,
     True, 1024, None),
]
# the width of MLA's direct form (mla-8b: head_dim 128 + rope_dim 64), whose
# cases zero v past its first MLA_V_DIM columns as the model pads it
MLA_FLASH_D, MLA_V_DIM = 192, 128
# row 16: the ring's chunk steps at the training shape of one shard of the
# ring-train phase (batch 2, 2048 positions a shard): the q chunk sits
# q_offset positions after the K/V chunk
FLASH_OFFSET_CASES = [
    # name, B, Hq, Hkv, S, D, causal, window, soft cap, q_offset
    ("ring q_offset 2048", 2, 32, 8, 2048, 128, True, None, None, 2048),
    ("ring q_offset 6144", 2, 32, 8, 2048, 128, True, None, None, 6144),
    ("ring q_offset 2048 window 512", 2, 32, 8, 2048, 128, True, 512, None,
     2048),
    ("ring q_offset 2048 soft cap 5", 2, 32, 8, 2048, 128, True, None, 5.0,
     2048),
    # MLA's direct form on one shard of a ring step
    ("MLA ring q_offset 2048 D=192", 2, 32, 32, 2048, 192, True, None, None,
     2048),
]


# phase 9g (a): rows 1-3 at a Gemma train step's heads (16 over 8 of 256,
# one sequence of 8192: Gemma 2's local layer under its 4096 window and cap
# 50, its global layer, Gemma 3's local layer under 1024) and row 16 at one
# shard of the seq = 2 Gemma 2 step (a local layer's band one shard back);
# the capped cases are also held at q drawn LARGE_Q times larger
GEMMA_FLASH_CASES = [
    # name, B, Hq, Hkv, S, D, causal, window, soft cap, q_offset, large q
    ("Gemma 2 local train B=1 S=8192 D=256 window 4096 soft cap 50", 1,
     16, 8, 8192, 256, True, 4096, 50.0, 0, LARGE_Q),
    ("Gemma 2 global train B=1 S=8192 D=256 soft cap 50", 1, 16, 8, 8192,
     256, True, None, 50.0, 0, LARGE_Q),
    ("Gemma 3 local train B=1 S=8192 D=256 window 1024", 1, 16, 8, 8192,
     256, True, 1024, None, 0, 0.0),
    ("Gemma 2 ring q_offset 4096 S=4096 D=256 window 4096 soft cap 50", 1,
     16, 8, 4096, 256, True, 4096, 50.0, 4096, LARGE_Q),
]
# row 12 with gradients at Gemma 2's and Gemma 3's widths over 8192 tokens,
# and Gemma 3's q/k norm over their 16 heads of 256
GEMMA_RMS_SHAPES = ((8192, 3584), (8192, 3840), (8192 * 16, 256))


def visible_pairs(s: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps for one head of s queries at
    positions q_offset.. against s keys at 0.."""
    if not causal:
        return s * s
    if window is None and q_offset == 0:
        return s * (s + 1) // 2
    total = 0
    for i in range(s):
        pos = q_offset + i
        lo = 0 if window is None else max(0, pos - window + 1)
        total += max(0, min(pos, s - 1) - lo + 1)
    return total


def flash_controls(torch, q, k, v, do, args, lse, delta, refs) -> dict:
    """Broken variants scored by the same check against the plain
    versions' (o, dq, dk, dv) = ``refs``. Every case: p.v accumulated in
    bf16 over 64-key tiles and P rounded to bf16 before P.V (against o),
    dK/dV with the last q head of each GQA group dropped, and dS rounded to
    bf16 (``bf16_ds_control``). Under a soft cap, the dQ and dK/dV kernels
    launched without it on the same lse and delta (the cap's Jacobian left
    out of the backward; each of dq, dk, dv must miss). Under a window,
    the three kernels at the window one short (the band's edge off by one;
    the forward, then the backward on its own lse and delta; the check must
    catch it in some output). At a q offset, ``zero_offset_control``. The
    share a control reports is the one its rule gates on."""
    from k8s_runpod_kubelet_tpu_torch.ops import flash_dkv, flash_dq, flash_fwd
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (
        _flash_dkv_plain, _flash_mask, _grouped)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    o_ref, _, dk_ref, dv_ref = refs
    qg = _grouped(q.float(), hkv) * args["sm_scale"]
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    del qg
    if args["logit_soft_cap"] is not None:
        cap = args["logit_soft_cap"]
        sc = torch.tanh(sc / cap) * cap
    mask = _flash_mask(s, s, args["causal"], args["sliding_window"],
                       q.device, args["q_offset"])
    if mask is not None:
        sc.masked_fill_(~mask, -math.inf)
    # a row that sees no key (a window at a ring offset) gives 0, as the
    # kernels do, not the NaN of a softmax over nothing
    o_bf16_p = torch.nan_to_num(bf16_p_output(torch, sc, v[:, :, None]),
                                nan=0.0).reshape(b, hq, s, d)
    err, share = tolerance_check(o_bf16_p.bfloat16(), o_ref)
    del o_bf16_p
    p = torch.nan_to_num(torch.softmax(sc, dim=-1), nan=0.0)
    del sc
    acc = torch.zeros((b, hkv, hq // hkv, s, d), dtype=torch.bfloat16,
                      device=q.device)
    vf = v.float()[:, :, None]
    for t0 in range(0, s, 64):
        acc = (acc.float() + p[..., t0:t0 + 64] @ vf[..., t0:t0 + 64, :]
               ).bfloat16()
    del p
    out = {"bf16_p": {"max_abs_err": err, "tolerance_share": share}}
    err, share = tolerance_check(acc.reshape(b, hq, s, d), o_ref)
    out["bf16_accumulation"] = {"max_abs_err": err, "tolerance_share": share}
    del acc
    dropped = _grouped(do.float(), hkv).clone()
    dropped[:, :, -1] = 0
    dk_c, dv_c = _flash_dkv_plain(q.float(), k.float(), v.float(),
                                  dropped.reshape(b, hq, s, d), lse, delta,
                                  **args)
    checks = [tolerance_check(dk_c.bfloat16(), dk_ref),
              tolerance_check(dv_c.bfloat16(), dv_ref)]
    out["dropped_q_head"] = {"max_abs_err": max(e for e, _ in checks),
                             "tolerance_share": max(s for _, s in checks)}
    del dk_c, dv_c, dropped
    out["bf16_ds"] = bf16_ds_control(torch, q, k, v, do, args, lse, delta,
                                     refs[1:])

    def scored(names, got) -> dict:
        ref_of = dict(zip(("o", "dq", "dk", "dv"), refs))
        return {n: dict(zip(("max_abs_err", "tolerance_share"),
                            tolerance_check(g, ref_of[n])))
                for n, g in zip(names, got)}

    if args["logit_soft_cap"] is not None:
        nocap = dict(args, logit_soft_cap=None)
        by = scored(("dq", "dk", "dv"),
                    (flash_dq(q, k, v, do, lse, delta, **nocap),
                     *flash_dkv(q, k, v, do, lse, delta, **nocap)))
        out["cap_left_out_of_backward"] = {
            "tolerance_share": min(c["tolerance_share"] for c in by.values()),
            "max_abs_err": max(c["max_abs_err"] for c in by.values()),
            "by_output": by}
    if args["causal"] and args["sliding_window"] is not None:
        short = dict(args, sliding_window=args["sliding_window"] - 1)
        o_c, lse_c = flash_fwd(q, k, v, **short)
        delta_c = (do.float() * o_c.float()).sum(-1)
        by = scored(("o", "dq", "dk", "dv"),
                    (o_c, flash_dq(q, k, v, do, lse_c, delta_c, **short),
                     *flash_dkv(q, k, v, do, lse_c, delta_c, **short)))
        out["window_one_short"] = {
            "tolerance_share": max(c["tolerance_share"] for c in by.values()),
            "max_abs_err": max(c["max_abs_err"] for c in by.values()),
            "by_output": by}
    if args["q_offset"]:
        out["q_offset_0"] = zero_offset_control(torch, q, k, v, do, args, lse,
                                                delta, refs)
    return out


def bf16_ds_control(torch, q, k, v, do, args, lse, delta, refs) -> dict:
    """The backward kernels' control: dS (and P) rounded to bf16 alone
    before the products that accumulate dq = scale dS k, dk = scale dS^T q
    and dv = P^T dO, scored against the plain versions' (dq, dk, dv) by the
    same check; the least of the three shares is the control's (every one
    must miss the check)."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import _flash_ds
    b, hq, s, d = q.shape
    scale = args["sm_scale"]
    p, ds, qg, dog = _flash_ds(q.float(), k.float(), v.float(), do.float(),
                               lse, delta, args["causal"], scale,
                               args["sliding_window"],
                               args["logit_soft_cap"], args["q_offset"])
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    kf = k.float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(b, hq, s, d)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg.float()) * scale
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog.float())
    del p, ds
    shares = {}
    for name, got, ref in (("dq", dq * scale, refs[0]), ("dk", dk, refs[1]),
                           ("dv", dv, refs[2])):
        err, share = tolerance_check(got.bfloat16(), ref)
        shares[name] = {"max_abs_err": err, "tolerance_share": share}
    return {"max_abs_err": max(c["max_abs_err"] for c in shares.values()),
            "tolerance_share": min(c["tolerance_share"]
                                   for c in shares.values()),
            "by_gradient": shares}


def zero_offset_control(torch, q, k, v, do, args, lse, delta, refs) -> dict:
    """Row 16's control: the same three kernels launched at q_offset 0 on
    the same inputs (the band of the chunk's own diagonal instead of the
    one q_offset behind), scored against the plain versions at the true
    offset by the same check; the least share of o, dq, dk and dv."""
    from k8s_runpod_kubelet_tpu_torch.ops import flash_dkv, flash_dq, flash_fwd
    zero = dict(args, q_offset=0)
    got = (flash_fwd(q, k, v, **zero)[0],
           flash_dq(q, k, v, do, lse, delta, **zero),
           *flash_dkv(q, k, v, do, lse, delta, **zero))
    shares = {}
    for name, g, ref in zip(("o", "dq", "dk", "dv"), got, refs):
        err, share = tolerance_check(g, ref)
        shares[name] = {"max_abs_err": err, "tolerance_share": share}
    return {"max_abs_err": max(c["max_abs_err"] for c in shares.values()),
            "tolerance_share": min(c["tolerance_share"]
                                   for c in shares.values()),
            "by_output": shares}


def large_q_check(torch, q, k, v, do, args, mult: float) -> dict:
    """A capped case again at q times ``mult`` (scores toward the cap):
    each of the three kernels' outputs (o, dq, dk, dv) within
    LARGE_Q_REL_L2 relative L2 of its plain version and within the
    per-element check (no element over), and the control, dQ and dK/dV
    launched without the cap on the same lse and delta, beyond the
    relative L2 limit in each of dq, dk and dv."""
    from k8s_runpod_kubelet_tpu_torch.ops import flash_dkv, flash_dq, flash_fwd
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (
        _flash_dkv_plain, _flash_dq_plain, _flash_fwd_plain)

    q = (q.float() * mult).bfloat16()
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    got = (o, flash_dq(q, k, v, do, lse, delta, **args),
           *flash_dkv(q, k, v, do, lse, delta, **args))
    nocap = dict(args, logit_soft_cap=None)
    broken = (flash_dq(q, k, v, do, lse, delta, **nocap),
              *flash_dkv(q, k, v, do, lse, delta, **nocap))
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    refs = (_flash_fwd_plain(qf, kf, vf, **args)[0],
            _flash_dq_plain(qf, kf, vf, dof, lse, delta, **args),
            *_flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args))
    del qf, kf, vf, dof

    def rel(g, r) -> float:
        return ((g.float() - r).norm() / r.norm()).item()

    by = {}
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, refs):
        share = (g.float() - r).abs() / (BF16_ATOL + BF16_RTOL * r.abs())
        by[name] = {"rel_l2": rel(g, r), "max_share": share.max().item(),
                    "elements_over": int((share > 1).sum()),
                    "elements": share.numel()}
        del share
    control = {n: rel(g, r) for n, g, r in zip(("dq", "dk", "dv"), broken,
                                               refs[1:])}
    worst = max(c["rel_l2"] for c in by.values())
    if not worst <= LARGE_Q_REL_L2:
        raise RuntimeError(f"q x {mult:g}: relative L2 {worst:.3e} over "
                           f"{LARGE_Q_REL_L2} ({by})")
    over = {n: c["elements_over"] for n, c in by.items() if c["elements_over"]}
    if over:
        raise RuntimeError(f"q x {mult:g}: elements over the per-element "
                           f"check {over} ({by})")
    if not min(control.values()) > LARGE_Q_REL_L2:
        raise RuntimeError(f"q x {mult:g}: the cap left out of the backward "
                           f"passed the relative L2 limit ({control})")
    return {"q_scale": mult, "limit": LARGE_Q_REL_L2, "by_output": by,
            "cap_left_out_of_backward_rel_l2": control}


# ``flex_call``'s compiled call and the scalars its score and mask
# functions capture: one torch.compile a process, a new shape compiles
# anew, a new cap, window or offset does not (they are the graph's inputs)
_FLEX: dict = {}
# the process that makes those compiles ahead (``--flex-warm``), the
# TorchInductor cache directory it shares with this one, and the shapes it
# has compiled: a compile of one of them here reads it back (8-25 s a
# shape cold on an H100, PERF.md §6)
_FLEX_WARM: dict = {}


def flex_shapes() -> list:
    """The (B, Hq, Hkv, S, D) of every capped flash case, in the order the
    smoke reaches them."""
    out = []
    for case in FLASH_CASES + FLASH_OFFSET_CASES + GEMMA_FLASH_CASES:
        b, hq, hkv, s, d, causal, window, cap = case[1:9]
        if cap is not None and (b, hq, hkv, s, d) not in out:
            out.append((b, hq, hkv, s, d))
    return out


def flex_call(torch, q, k, v, args):
    """``torch.nn.attention.flex_attention``, compiled, on copies of q, k
    and v that need gradients: the cap as its score function (cap tanh(s
    / cap)), the causal band at the case's q offset and window as its
    block mask, GQA by ``enable_gqa``. Returns (the call, the three
    leaves)."""
    import torch._functorch.config as functorch_config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if not _FLEX:
        # its backward is timed again and again on one graph (retain_graph),
        # which a backward that donates its saved buffers refuses
        functorch_config.donated_buffer = False
        dev = q.device
        cap = torch.ones((), device=dev)
        win = torch.zeros((), dtype=torch.int64, device=dev)
        off = torch.zeros((), dtype=torch.int64, device=dev)

        def score_mod(score, b, h, q_idx, kv_idx):
            return torch.tanh(score / cap) * cap

        def mask_mod(b, h, q_idx, kv_idx):
            pos = q_idx + off
            return (kv_idx <= pos) & (pos - kv_idx < win)

        _FLEX.update(call=torch.compile(flex_attention, dynamic=False),
                     cap=cap, win=win, off=off, score_mod=score_mod,
                     mask_mod=mask_mod)
    f = _FLEX
    s = q.shape[2]
    f["cap"].fill_(args["logit_soft_cap"])
    f["win"].fill_(s + args["q_offset"] + 1 if args["sliding_window"] is None
                   else args["sliding_window"])
    f["off"].fill_(args["q_offset"])
    block = (create_block_mask(f["mask_mod"], None, None, s, s,
                               device=q.device)
             if args["causal"] else None)
    leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))

    def call():
        return f["call"](*leaves, score_mod=f["score_mod"], block_mask=block,
                         scale=args["sm_scale"], enable_gqa=True)

    return call, leaves


def flex_library(torch, q, k, v, do, args, o_ref, reps: int, flush) -> dict:
    """The library call of a case under a soft cap, which SDPA does not
    take (``flex_call``): its forward (on inputs that need gradients, so
    one compile serves both) and its autograd backward (dq, dk and dv
    together), timed as SDPA's are; the first call's seconds (the compile,
    read back from the warm process's cache where it made this shape) and
    its output's largest share of the check against the plain forward's
    are read, not gated."""
    wait_flex_warm(tuple(q.shape[:2]) + (k.shape[1],) + tuple(q.shape[2:]))
    call, leaves = flex_call(torch, q, k, v, args)
    t0 = time.perf_counter()
    lo = call()
    torch.autograd.grad(lo, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _, share = tolerance_check(lo, o_ref)
    fwd_ms = time_ms(torch, call, reps, flush)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        lo, leaves, do, retain_graph=True), reps, flush)
    del lo, leaves, call
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "first_call_s": first_s,
            "o_tolerance_share": share}


def flex_warm(torch, dev) -> None:
    """``--flex-warm``: compile ``flex_call``'s forward and backward at
    every shape of ``flex_shapes`` on zeros, printing ``compiled [B, Hq,
    Hkv, S, D]`` as each is done."""
    for key in flex_shapes():
        b, hq, hkv, s, d = key
        q, do = (torch.zeros((b, hq, s, d), dtype=torch.bfloat16, device=dev)
                 for _ in range(2))
        k, v = (torch.zeros((b, hkv, s, d), dtype=torch.bfloat16,
                            device=dev) for _ in range(2))
        args = dict(causal=True, sm_scale=d ** -0.5, sliding_window=None,
                    logit_soft_cap=1.0, q_offset=0)
        call, leaves = flex_call(torch, q, k, v, args)
        torch.autograd.grad(call(), leaves, do)
        torch.cuda.synchronize()
        print("compiled " + json.dumps(list(key)), flush=True)


def start_flex_warm() -> None:
    """Start ``--flex-warm`` in a process of its own at a lower priority,
    with a TorchInductor cache directory this process uses too."""
    cache = tempfile.mkdtemp(prefix="chip-smoke-inductor-")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache
    err = open(os.path.join(cache, "warm.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--flex-warm"],
        stdout=subprocess.PIPE, stderr=err, text=True,
        preexec_fn=lambda: os.nice(10))
    _FLEX_WARM.update(proc=proc, cache=cache, err=err, done=set(),
                      waited_s=0.0)
    atexit.register(stop_flex_warm)


def wait_flex_warm(key: tuple) -> None:
    """Wait until the warm process has compiled ``key`` or has ended (a
    shape it did not make compiles here, cold)."""
    w = _FLEX_WARM
    if not w or key in w["done"]:
        return
    t0 = time.perf_counter()
    for line in w["proc"].stdout:
        if line.startswith("compiled "):
            w["done"].add(tuple(json.loads(line[len("compiled "):])))
            if key in w["done"]:
                break
    w["waited_s"] += time.perf_counter() - t0


def stop_flex_warm() -> None:
    """End the warm process and remove the cache directory."""
    w = _FLEX_WARM
    if not w:
        return
    if w["proc"].poll() is None:
        w["proc"].kill()
    w["proc"].wait()
    w["err"].close()
    shutil.rmtree(w["cache"], ignore_errors=True)
    _FLEX_WARM.clear()


def sdpa_backend(torch, q, k, v, **sdpa) -> str:
    """The backend PyTorch's dispatcher picks for these SDPA arguments (a
    private query, so "not read" where this PyTorch lacks it)."""
    try:
        from torch.nn.attention import SDPBackend
        idx = torch._fused_sdp_choice(q, k, v, sdpa.get("attn_mask"), 0.0,
                                      sdpa.get("is_causal", False),
                                      scale=sdpa.get("scale"),
                                      enable_gqa=sdpa.get("enable_gqa",
                                                          False))
        return SDPBackend(idx).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as e:
        return f"not read ({type(e).__name__})"


def flash_case(torch, F, dev, flush, name, b, hq, hkv, s, d, causal, window,
               cap, q_offset=0, large_q=0.0) -> dict:
    """The three flash kernels on one shape against their plain versions,
    with broken controls that must miss the check (``flash_controls``), the
    autograd path, and times beside the bound, the plain versions and the
    library: SDPA, or under a soft cap compiled ``flex_attention``
    (``flex_library``). With ``large_q`` the case is held again at q that
    many times larger (``large_q_check``)."""
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_attention, flash_dkv,
                                                  flash_dq, flash_fwd)
    from k8s_runpod_kubelet_tpu_torch.ops.attention import (
        _attention_plain, _flash_dkv_plain, _flash_dq_plain,
        _flash_fwd_plain)

    gen = torch.Generator().manual_seed(SEED + s + d + hkv)
    q, do = (torch.randn((b, hq, s, d), generator=gen) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen) for _ in range(2))
    if d == MLA_FLASH_D:
        v[..., MLA_V_DIM:] = 0     # MLA's v, zero-padded to the q/k width
    q, k, v, do = (t.to(dev, torch.bfloat16) for t in (q, k, v, do))
    args = dict(causal=causal, sm_scale=d ** -0.5, sliding_window=window,
                logit_soft_cap=cap, q_offset=q_offset)
    kernels = (flash_fwd, flash_dq, flash_dkv)
    before = [f.launches for f in kernels]
    o, lse = flash_fwd(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_dq(q, k, v, do, lse, delta, **args)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **args)
    torch.cuda.synchronize()
    if [f.launches for f in kernels] != [n + 1 for n in before]:
        raise RuntimeError(f"flash {name}: a kernel did not launch")

    # each kernel against its plain version on the same inputs, in f32
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd_plain(qf, kf, vf, **args)
    dq_ref = _flash_dq_plain(qf, kf, vf, dof, lse, delta, **args)
    dk_ref, dv_ref = _flash_dkv_plain(qf, kf, vf, dof, lse, delta, **args)
    checks = {"flash_fwd": [tolerance_check(o, o_ref),
                            tolerance_check(lse, lse_ref, F32_ATOL,
                                            F32_RTOL)],
              "flash_dq": [tolerance_check(dq, dq_ref)],
              "flash_dkv": [tolerance_check(dk, dk_ref),
                            tolerance_check(dv, dv_ref)]}
    del qf, kf, vf, dof
    controls = flash_controls(torch, q, k, v, do, args, lse, delta,
                              (o_ref, dq_ref, dk_ref, dv_ref))
    del dq_ref, dk_ref, dv_ref
    for kname, results in checks.items():
        for err, share in results:
            if share > 1:
                raise RuntimeError(f"{kname} {name}: max abs err {err}, "
                                   f"{share:.2f}x the tolerance")
    for control, c in controls.items():
        if not c["tolerance_share"] > 1:
            raise RuntimeError(f"flash {name}: the {control} control passed "
                               "the check")
    large = (large_q_check(torch, q, k, v, do, args, large_q)
             if large_q else None)

    # the whole autograd path against autograd through the plain attention
    # (flash_attention has no offset: the ring's autograd path is held in
    # the ring-train phase)
    e2e = {}
    if not q_offset:
        fa = {k_: v_ for k_, v_ in args.items() if k_ != "q_offset"}
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        flash_attention(tq, tk, tv, **fa).backward(do)
        pq, pk, pv = (t.float().requires_grad_() for t in (q, k, v))
        _attention_plain(pq, pk, pv, **fa).backward(do.float())
        for gname, got, want in (("dq", tq.grad, pq.grad),
                                 ("dk", tk.grad, pk.grad),
                                 ("dv", tv.grad, pv.grad)):
            err = (got.float() - want).abs().max().item()
            e2e[gname] = err / (E2E_SCALE_RTOL * want.abs().max().item())
            if not e2e[gname] <= 1:
                raise RuntimeError(f"flash {name}: autograd d{gname} "
                                   "differs from the plain attention's by "
                                   f"{err}")
        del tq, tk, tv, pq, pk, pv

    # times: kernels, plain versions, the library (forward and autograd
    # backward)
    reps = 5 if b * hq * s * s > 2 ** 31 else 10
    fwd_ms = time_ms(torch, lambda: flash_fwd(q, k, v, **args), reps, flush)
    dq_ms = time_ms(torch, lambda: flash_dq(q, k, v, do, lse, delta, **args),
                    reps, flush)
    dkv_ms = time_ms(torch, lambda: flash_dkv(q, k, v, do, lse, delta,
                                              **args), reps, flush)
    plain = {"flash_fwd": time_ms(torch, lambda: _flash_fwd_plain(
                 q, k, v, **args), 3, flush),
             "flash_dq": time_ms(torch, lambda: _flash_dq_plain(
                 q, k, v, do, lse, delta, **args), 3, flush),
             "flash_dkv": time_ms(torch, lambda: _flash_dkv_plain(
                 q, k, v, do, lse, delta, **args), 3, flush)}
    flex = None
    if cap is not None:
        flex = flex_library(torch, q, k, v, do, args, o_ref, reps, flush)
        lib_fwd, lib_bwd = flex["fwd_ms"], flex["bwd_ms"]
        backend = "flex_attention (compiled)"
    else:
        from k8s_runpod_kubelet_tpu_torch.ops.attention import _flash_mask
        if q_offset:
            # row 16: every key visible (non-causal), or the band as a mask;
            # GQA by enable_gqa
            ks, vs = k, v
            mask = (None if window is None else
                    _flash_mask(s, s, True, window, dev, q_offset))
            sdpa = dict(attn_mask=mask, is_causal=False,
                        scale=args["sm_scale"], enable_gqa=True)
        else:
            ks, vs = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            mask = None
            if window is not None:
                mask = _flash_mask(s, s, True, window, dev)
            sdpa = dict(attn_mask=mask, is_causal=causal and mask is None,
                        scale=args["sm_scale"])
        backend = "SDPA " + sdpa_backend(torch, q, ks, vs, **sdpa)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ks, vs, **sdpa), reps, flush)
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, ks, vs))
        lo = F.scaled_dot_product_attention(lq, lk, lv, **sdpa)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True), reps, flush)
        del ks, vs, lq, lk, lv, lo
    del o_ref

    pairs = b * hq * visible_pairs(s, causal, window, q_offset)
    qb, kb = q.numel() * 2, k.numel() * 2
    rows = b * hq * s * 4                      # one f32 per row (lse, delta)
    work = {"flash_fwd": (4 * pairs * d, 2 * qb + 2 * kb + rows, fwd_ms,
                          lib_fwd),
            "flash_dq": (6 * pairs * d, 3 * qb + 2 * kb + 2 * rows, dq_ms,
                         lib_bwd),
            "flash_dkv": (8 * pairs * d, 2 * qb + 4 * kb + 2 * rows, dkv_ms,
                          lib_bwd)}
    rec = {"case": name, "B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
           "causal": causal, "window": window, "soft_cap": cap,
           "q_offset": q_offset, "visible_pairs": pairs,
           "large_q": large, "library": backend, "flex": flex,
           "controls": controls,
           "autograd_vs_plain_share": e2e or None,
           "tolerance": TOLERANCE, "kernels": {}}
    for kname, (ops, nbytes, ms, lib) in work.items():
        bound_ms, bound_by = bound(nbytes, ops, BF16_TENSOR_FLOPS)
        rec["kernels"][kname] = {
            "max_abs_err": max(e for e, _ in checks[kname]),
            "tolerance_share": max(sh for _, sh in checks[kname]),
            "ms": ms, "plain_ms": plain[kname], "library_ms": lib,
            "library": backend,
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": nbytes, "tflops": ops / ms / 1e9}
    lib_txt = (f"{backend}: fwd {lib_fwd:.3f} ms, autograd bwd "
               f"{lib_bwd:.3f} ms")
    if flex:
        lib_txt += (f" (first call {flex['first_call_s']:.1f} s, o "
                    f"{flex['o_tolerance_share']:.2f} of the check)")
    e2e_txt = ("autograd vs plain (share of 1% of scale) " + " ".join(
        f"{g} {x:.2f}" for g, x in e2e.items()) if e2e else
        "autograd path: the ring-train phase")
    ctl_txt = (
        f"bf16 accumulation "
        f"{controls['bf16_accumulation']['tolerance_share']:.2f}, bf16 "
        f"P {controls['bf16_p']['tolerance_share']:.2f}, dropped q head "
        f"{controls['dropped_q_head']['tolerance_share']:.0f}, bf16 dS "
        + "/".join(f"{c['tolerance_share']:.2f}" for c in
                   controls["bf16_ds"]["by_gradient"].values())
        + " (dq/dk/dv)" + "".join(
            f", {c.replace('_', ' ')} " + "/".join(
                f"{x['tolerance_share']:.1f}" for x in
                controls[c]["by_output"].values())
            + " (" + "/".join(controls[c]["by_output"]) + ")"
            for c in ("cap_left_out_of_backward", "window_one_short",
                      "q_offset_0") if c in controls))
    log(f"  flash {name}: library {lib_txt}; controls: {ctl_txt}; "
        f"{e2e_txt}")
    if large:
        log(f"    at q x {large['q_scale']:g}: relative L2 " + ", ".join(
            f"{n} {r['rel_l2']:.2e}" for n, r in large["by_output"].items())
            + f" (limit {LARGE_Q_REL_L2}); the cap left out of the backward "
            + ", ".join(f"{n} {x:.2e}" for n, x in
                        large["cap_left_out_of_backward_rel_l2"].items())
            + "; per element (none may be over): " + ", ".join(
                f"{n} {r['max_share']:.2f} ({r['elements_over']} of "
                f"{r['elements']} over)"
                for n, r in large["by_output"].items()))
    for kname, r in rec["kernels"].items():
        log(f"    {kname}: max_abs_err {r['max_abs_err']:.3e} "
            f"({r['tolerance_share']:.2f} of {TOLERANCE}) kernel "
            f"{r['ms']:.3f} ms ({r['tflops']:.1f} TFLOP/s), bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms")
    return rec


# -- phases 9-10: training ----------------------------------------------------------

def leaf_names(tree: dict, prefix: str = "") -> list[str]:
    """Names of a parameter tree's leaves in ``_leaves`` order."""
    out = []
    for name in sorted(tree):
        leaf = tree[name]
        out.extend(leaf_names(leaf, f"{prefix}{name}/")
                   if isinstance(leaf, dict) else [prefix + name])
    return out


def train_grad_check(torch, dev, cfg, batch) -> dict:
    """Step 1's gradients as the training path computes them
    (``loss_and_grads``: bf16 compute through the kernels, remat) against
    autograd of ``plain_logits`` in f32 on the same f32 master params and
    the same batch, one row at a time. Each leaf's relative L2 error and
    the global norm's relative error must stay within their limits; the
    same path with the dK/dV kernel's output zeroed (the control) must
    exceed the leaf limit."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, init_params
    from k8s_runpod_kubelet_tpu_torch.ops import attention
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        _ce_and_zloss, _leaves, global_norm, loss_and_grads)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    rows = batch.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = [torch.zeros_like(p) for p in leaves]
    ref_loss = 0.0
    for r in range(rows):
        mb = batch[r:r + 1]
        logits = plain_logits(torch, cfg, params, mb[:, :-1])
        ce, _ = _ce_and_zloss(logits, mb[:, 1:], 0.0)
        del logits
        for acc, g in zip(ref, torch.autograd.grad(ce / rows, leaves)):
            acc.add_(g)
        ref_loss += ce.item() / rows
        del ce
    ref_norm = global_norm(ref).item()
    ref_s = time.perf_counter() - t0
    model = LlamaModel(cfg, dev)

    def against_ref() -> dict:
        loss, grads = loss_and_grads(model, params, batch)
        errs = {n: ((g.float() - r).norm() / r.norm()).item()
                for n, g, r in zip(names, grads, ref)}
        norm = global_norm(grads).item()
        del grads
        worst = max(errs, key=errs.get)
        return {"loss": loss.item(), "grad_norm": norm,
                "norm_rel_err": abs(norm - ref_norm) / ref_norm,
                "leaf_rel_l2": errs, "worst_leaf": worst,
                "worst_leaf_rel_l2": errs[worst]}

    port = against_ref()
    real_dkv = attention.flash_dkv
    attention.flash_dkv = lambda q, k, v, *a, **kw: (torch.zeros_like(k),
                                                     torch.zeros_like(v))
    try:
        control = against_ref()
    finally:
        attention.flash_dkv = real_dkv
    peak = torch.cuda.max_memory_allocated()
    del params, leaves, ref, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rows": rows, "ref_loss": ref_loss, "ref_grad_norm": ref_norm,
           "ref_s": ref_s, "peak_bytes": peak, "port": port,
           "control_zero_dkv": control,
           "limit_leaf_rel_l2": TRAIN_GRAD_REL_L2_LIMIT,
           "limit_norm_rel": TRAIN_NORM_REL_LIMIT}
    log(f"  gradients vs autograd of the plain f32 forward (batch "
        f"{rows} x {batch.shape[1] - 1}, {ref_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB): loss "
        f"{port['loss']:.5f} vs {ref_loss:.5f}; grad_norm "
        f"{port['grad_norm']:.5f} vs {ref_norm:.5f} (rel "
        f"{port['norm_rel_err']:.2e}, limit {TRAIN_NORM_REL_LIMIT}); worst "
        f"leaf {port['worst_leaf']} rel L2 {port['worst_leaf_rel_l2']:.2e} "
        f"(limit {TRAIN_GRAD_REL_L2_LIMIT})")
    log("    leaf rel L2: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (dK/dV zeroed): worst leaf {control['worst_leaf']} rel "
        f"L2 {control['worst_leaf_rel_l2']:.3f}, grad_norm rel "
        f"{control['norm_rel_err']:.2e}")
    if not (port["worst_leaf_rel_l2"] <= TRAIN_GRAD_REL_L2_LIMIT
            and port["norm_rel_err"] <= TRAIN_NORM_REL_LIMIT):
        raise RuntimeError(f"training gradients off the plain forward's: "
                           f"{port}")
    if not control["worst_leaf_rel_l2"] > TRAIN_GRAD_REL_L2_LIMIT:
        raise RuntimeError(f"the zeroed-dK/dV control passed: {control}")
    return out


def train_phase(torch, dev, card: str, cfg=None, chunks: int = 0) -> dict:
    """Phase 9 (``cfg`` None: llama3-8b widths at 4 layers), 9m (mla-8b
    widths at 4 layers) or 9e (a) and (b) (an MoE config; ``chunks`` > 0
    the fused loss over that many vocab chunks): the gradient check
    (``moe_train_grad_check`` for an MoE config), then 6 steps on one
    repeated seeded batch with exact launches a step (flash at D = 192 for
    MLA: one forward launch a layer and its remat recompute, one dQ and
    one dK/dV; the norms of each layer twice, three a layer for MLA's
    attn, c and mlp norms, and the final one); an MoE run's aux_loss
    finite each step, with each routed layer's dropped share and
    load-balance loss logged (``RoutingWatch``)."""
    from k8s_runpod_kubelet_tpu_torch.models import llama3_8b
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, synthetic_batches)

    cfg = cfg or dataclasses.replace(llama3_8b(), n_layers=4)
    n_layers = cfg.n_layers
    layer_norms = 2 + (cfg.is_mla + (cfg.mla_q_lora_rank is not None))
    tc = TrainConfig(batch_size=8, seq_len=2048, steps=6, warmup_steps=1,
                     fused_ce_chunks=chunks)
    batch = next(synthetic_batches(cfg, tc, seed=SEED, device=dev))
    grad_check = (moe_train_grad_check(torch, dev, cfg, batch, chunks)
                  if cfg.n_experts else train_grad_check(torch, dev, cfg,
                                                         batch))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tc, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(trainer.params))
    log(f"  {cfg.name} widths, {n_layers} layers: {n_params / 1e9:.3f} B "
        f"params (f32 master), init {init_s:.1f} s; batch {tc.batch_size} x "
        f"seq {tc.seq_len}, remat {cfg.remat_policy}, lr {tc.learning_rate}"
        f", fused_ce_chunks {chunks}")
    batches = itertools.repeat(batch)
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": 2 * n_layers, "flash_dq": n_layers,
                "flash_dkv": n_layers,
                "rms_norm": 2 * (layer_norms * n_layers) + 1}
    n_routed = n_layers - cfg.n_dense_prefix if cfg.n_experts else 0
    watch = RoutingWatch(torch, trainer, n_routed) if n_routed else None
    # the main path: counts set to 0 just before the run, read just after
    for k in kernels:
        k.launches = 0
    try:
        run = timed_steps(torch, trainer, batches, tc.steps, kernels,
                          per_step)
    finally:
        routing = (watch.close(tc.batch_size * tc.seq_len
                               * cfg.n_experts_per_tok) if watch else None)
    launches = {k.__name__: k.launches for k in kernels}
    if routing is not None:
        log(f"  aux_loss by step {[round(a, 6) for a in routing['aux_loss']]}"
            f"; by routed layer, step 1 then {tc.steps}: dropped share "
            f"{[round(d, 4) for d in routing['drop_share'][0]]} -> "
            f"{[round(d, 4) for d in routing['drop_share'][-1]]}, "
            f"load-balance loss (uniform 1.0) "
            f"{[round(b, 4) for b in routing['load_balance'][0]]} -> "
            f"{[round(b, 4) for b in routing['load_balance'][-1]]}")
        if not all(math.isfinite(a) and a > 0 for a in routing["aux_loss"]):
            raise RuntimeError(f"aux_loss {routing['aux_loss']}")
    losses, norms, walls = run["losses"], run["grad_norms"], \
        run["step_walls_s"]
    peak, step_s, tok_s = (run["peak_bytes"], run["step_s_median"],
                           run["tokens_per_s"])
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    # step 1 ran on the params and batch of the gradient check
    step1_rel = (abs(norms[0] - grad_check["ref_grad_norm"])
                 / grad_check["ref_grad_norm"])
    log(f"  step 1 grad_norm {norms[0]:.5f} vs the plain f32 forward's "
        f"{grad_check['ref_grad_norm']:.5f}: rel {step1_rel:.2e} (limit "
        f"{TRAIN_NORM_REL_LIMIT})")
    if not step1_rel <= TRAIN_NORM_REL_LIMIT:
        raise RuntimeError(f"step 1's grad_norm {norms[0]} is off the plain "
                           f"forward's {grad_check['ref_grad_norm']}")
    log(f"  [{card}] step wall {step_s:.3f} s (median of steps 2-"
        f"{tc.steps}; first {walls[0]:.3f} s), {tok_s:.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB allocated")
    log(f"  launches over {tc.steps} steps: {launches} ({per_step} per step)")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": n_layers, "params": n_params,
            "batch": tc.batch_size, "seq_len": tc.seq_len, "steps": tc.steps,
            "losses": losses, "grad_norms": norms, "step_walls_s": walls,
            "step_s_median": step_s, "tokens_per_s": tok_s,
            "peak_bytes": peak, "launches": launches,
            "launches_per_step": per_step, "init_s": init_s,
            "fused_ce_chunks": chunks, "routing": routing,
            "grad_check": grad_check, "step1_norm_rel_err": step1_rel}


def plain_attention_blocked(torch, q, k, v, scale, block, window=None,
                            cap=None):
    """Causal attention in f32 (under ``window``, each query sees the last
    ``window`` positions; with ``cap`` the scores pass cap * tanh(s / cap)
    before the mask), a block of query rows at a time against the
    keys up to the block's last position, each with an exact softmax:
    q (B, Hq, S, D), k/v (B, Hkv, S, D). No kernels, no online softmax, no
    ring; the blocks only bound the scores' memory."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    out = []
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        qb = q[:, :, i0:i1].reshape(b, hkv, hq // hkv, i1 - i0, d) * scale
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qb, k[:, :, :i1])
        if cap is not None:
            sc = torch.tanh(sc / cap) * cap
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(i1, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep &= qpos - kpos < window
        p = torch.softmax(sc.masked_fill(~keep, -math.inf), dim=-1)
        out.append(torch.einsum("bhgqk,bhkd->bhgqd", p, v[:, :, :i1])
                   .reshape(b, hq, i1 - i0, d))
    return torch.cat(out, dim=2)


def plain_logits_long(torch, cfg, params, tokens, block=2048):
    """``plain_logits`` for long rows: the same plain f32 forward with
    causal attention by ``plain_attention_blocked`` (an MLA model's in the
    direct form, ``mla_direct_qkv``), each layer under
    ``torch.utils.checkpoint`` (only its input kept for the backward)."""
    import torch.nn.functional as F
    import torch.utils.checkpoint

    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import (apply_rope,
                                                       rope_frequencies)

    hd = cfg.head_dim_
    cos, sin = rope_frequencies(cfg.mla_rope_dim if cfg.is_mla else hd,
                                cfg.max_seq_len, cfg.rope_theta,
                                cfg.rope_scaling,
                                device=params["tok_embed"].device)

    def layer(x, lp):
        b, n, _ = x.shape
        h = _rms_norm_plain(x, lp["attn_norm"], cfg.norm_eps)
        if cfg.is_mla:
            q, k, v = mla_direct_qkv(torch, cfg, lp, h, cos, sin)
        else:
            q = apply_rope((h @ lp["wq"]).view(b, n, cfg.n_heads, hd), cos,
                           sin)
            k = apply_rope((h @ lp["wk"]).view(b, n, cfg.n_kv_heads, hd),
                           cos, sin)
            v = (h @ lp["wv"]).view(b, n, cfg.n_kv_heads, hd)
        o = plain_attention_blocked(torch, q.transpose(1, 2),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    cfg.sm_scale, block)
        x = x + o.transpose(1, 2)[..., :hd].reshape(b, n, -1) @ lp["wo"]
        h = _rms_norm_plain(x, lp["mlp_norm"], cfg.norm_eps)
        return x + plain_mlp(torch, F, cfg, lp, h)

    x = params["tok_embed"][tokens.long()].float()
    for i in range(cfg.n_layers):
        lp = {k: layer_f32(w, i) for k, w in params["layers"].items()}
        x = torch.utils.checkpoint.checkpoint(layer, x, lp,
                                              use_reentrant=False)
    x = _rms_norm_plain(x, params["final_norm"], cfg.norm_eps)
    return x @ layer_f32(params["lm_head"])


def rel_l2(torch, got, want, rows: int = 1024) -> float:
    """||got - want|| / ||want|| over two same-shaped tensors, summed in
    f32 a slab of rows at a time (the logits of 16,384 tokens are 4 GB in
    bf16)."""
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    num = den = 0.0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows].float(), b[i:i + rows].float()
        num += (x - y).square().sum().item()
        den += y.square().sum().item()
    return math.sqrt(num / den)


def ring_checks(torch, dev, cfg, mesh, batch) -> dict:
    """Step 1 of the ring (``ring_flash``, the flash kernels at each ring
    offset) on the seeded f32 master params and batch, held three ways:
    its gradients against autograd of a plain f32 forward over the whole
    sequence (``plain_logits_long``, one row at a time; every leaf's
    relative L2 and the global norm, phase 9's limits); its forward's
    logits and every leaf's gradient against the unsharded flash forward
    and step (the ``RING_*`` limits); and the control, every ring offset
    forced to 0, which must exceed both of those limits."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, init_params
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        _ce_and_zloss, _leaves, global_norm, loss_and_grads)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    rows = batch.shape[0]
    t0 = time.perf_counter()
    ref = [torch.zeros_like(p) for p in leaves]
    ref_loss = 0.0
    for r in range(rows):
        mb = batch[r:r + 1]
        logits = plain_logits_long(torch, cfg, params, mb[:, :-1])
        ce, _ = _ce_and_zloss(logits, mb[:, 1:], 0.0)
        del logits
        for acc, g in zip(ref, torch.autograd.grad(ce / rows, leaves)):
            acc.add_(g)
        ref_loss += ce.item() / rows
        del ce
    ref_norm = global_norm(ref).item()
    ref_s = time.perf_counter() - t0
    ring = LlamaModel(dataclasses.replace(cfg, ring_flash=True), dev, mesh)
    flat = LlamaModel(cfg, dev)
    inputs = batch[:, :-1]

    loss_r, grads_r = loss_and_grads(ring, params, batch)
    vs_ref = {n: ((g.float() - r).norm() / r.norm()).item()
              for n, g, r in zip(names, grads_r, ref)}
    norm_r = global_norm(grads_r).item()
    del ref
    _, grads_f = loss_and_grads(flat, params, batch)
    norm_f = global_norm(grads_f).item()

    def against_flat(model) -> dict:
        with torch.no_grad():
            got = model.forward(params, inputs)
            want = flat.forward(params, inputs)
            logits = rel_l2(torch, got, want)
            del got, want
        loss, grads = loss_and_grads(model, params, batch)
        errs = {n: ((g.float() - f.float()).norm() / f.float().norm()).item()
                for n, g, f in zip(names, grads, grads_f)}
        del grads
        worst = max(errs, key=errs.get)
        return {"loss": loss.item(), "logits_rel_l2": logits,
                "leaf_rel_l2": errs, "worst_leaf": worst,
                "worst_leaf_rel_l2": errs[worst]}

    port = against_flat(ring)
    ring_mod = importlib.import_module(
        "k8s_runpod_kubelet_tpu_torch.ops.ring_attention")
    kernels = {n: getattr(ring_mod, n) for n in
               ("flash_fwd", "flash_dq", "flash_dkv")}
    for n, fn in kernels.items():
        setattr(ring_mod, n, lambda *a, _fn=fn, **kw: _fn(
            *a, **dict(kw, q_offset=0)))
    try:
        control = against_flat(ring)
    finally:
        for n, fn in kernels.items():
            setattr(ring_mod, n, fn)
    peak = torch.cuda.max_memory_allocated()
    del params, leaves, grads_r, grads_f, ring, flat
    gc.collect()
    torch.cuda.empty_cache()
    worst_ref = max(vs_ref, key=vs_ref.get)
    out = {"rows": rows, "ref_loss": ref_loss, "ref_grad_norm": ref_norm,
           "ref_s": ref_s, "ring_loss": loss_r.item(),
           "ring_grad_norm": norm_r, "flat_grad_norm": norm_f,
           "ring_vs_ref_norm_rel": abs(norm_r - ref_norm) / ref_norm,
           "ring_vs_ref_leaf_rel_l2": vs_ref, "ring_vs_ref_worst_leaf":
           worst_ref, "ring_vs_flat": port, "control_q_offset_0": control,
           "peak_bytes": peak,
           "limits": {"leaf_rel_l2_vs_ref": TRAIN_GRAD_REL_L2_LIMIT,
                      "norm_rel_vs_ref": TRAIN_NORM_REL_LIMIT,
                      "logits_rel_l2_vs_flat": RING_LOGITS_REL_L2_LIMIT,
                      "leaf_rel_l2_vs_flat": RING_GRAD_REL_L2_LIMIT}}
    log(f"  ring step 1 vs autograd of the plain f32 forward (batch {rows} "
        f"x {batch.shape[1] - 1}, {ref_s:.1f} s): loss {loss_r.item():.5f} "
        f"vs {ref_loss:.5f}; grad_norm {norm_r:.5f} vs {ref_norm:.5f} (rel "
        f"{out['ring_vs_ref_norm_rel']:.2e}, limit {TRAIN_NORM_REL_LIMIT}); "
        f"worst leaf {worst_ref} rel L2 {vs_ref[worst_ref]:.2e} (limit "
        f"{TRAIN_GRAD_REL_L2_LIMIT})")
    log("    leaf rel L2 vs plain f32: " + ", ".join(
        f"{n} {e:.2e}" for n, e in vs_ref.items()))
    log(f"  ring vs the unsharded flash forward and step: logits rel L2 "
        f"{port['logits_rel_l2']:.2e} (limit {RING_LOGITS_REL_L2_LIMIT}), "
        f"worst leaf {port['worst_leaf']} {port['worst_leaf_rel_l2']:.2e} "
        f"(limit {RING_GRAD_REL_L2_LIMIT}); grad_norm {norm_r:.5f} vs "
        f"{norm_f:.5f}")
    log("    leaf rel L2 vs unsharded: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (ring offsets forced to 0): logits rel L2 "
        f"{control['logits_rel_l2']:.3f}, worst leaf "
        f"{control['worst_leaf']} {control['worst_leaf_rel_l2']:.3f}")
    if not (vs_ref[worst_ref] <= TRAIN_GRAD_REL_L2_LIMIT
            and out["ring_vs_ref_norm_rel"] <= TRAIN_NORM_REL_LIMIT):
        raise RuntimeError("the ring's gradients are off the plain f32 "
                           f"forward's: {vs_ref}, norm {norm_r} vs "
                           f"{ref_norm}")
    if not (port["logits_rel_l2"] <= RING_LOGITS_REL_L2_LIMIT
            and port["worst_leaf_rel_l2"] <= RING_GRAD_REL_L2_LIMIT):
        raise RuntimeError(f"the ring is off the unsharded step: {port}")
    if not (control["logits_rel_l2"] > RING_LOGITS_REL_L2_LIMIT
            and control["worst_leaf_rel_l2"] > RING_GRAD_REL_L2_LIMIT):
        raise RuntimeError(f"the zero-offset control passed: {control}")
    return out


def timed_steps(torch, trainer, batches, steps: int, counted=(),
                per_step=None) -> dict:
    """Run ``steps`` train steps one at a time, each logged: losses, grad
    norms, walls, peak memory, and (where ``per_step`` is given) each
    step's launches of the ``counted`` kernel wrappers checked exactly;
    every loss and grad norm must be finite."""
    losses, norms, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(steps):
        before = {k.__name__: k.launches for k in counted}
        out = trainer.run(steps=1, batches=batches)
        got = {k.__name__: k.launches - before[k.__name__] for k in counted}
        if per_step is not None and got != per_step:
            raise RuntimeError(f"step {step + 1} launched {got}, not "
                               f"{per_step}")
        losses.append(out["final_loss"])
        norms.append(out["grad_norm"])
        walls.append(out["wall_s"])
        log(f"  step {trainer.step}: loss {out['final_loss']:.4f}, "
            f"grad_norm {out['grad_norm']:.4f}, wall {out['wall_s']:.3f} s")
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"non-finite loss or grad norm: {losses} {norms}")
    step_s = statistics.median(walls[1:])
    tokens = trainer.tc.batch_size * trainer.tc.seq_len
    return {"steps": steps, "losses": losses, "grad_norms": norms,
            "step_walls_s": walls, "step_s_median": step_s,
            "tokens_per_s": tokens / step_s,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def ring_train_phase(torch, dev, card: str, cfg=None,
                     steps: int = 6) -> dict:
    """Sequence-sharded training in one process: the trainer on an
    in-process mesh of RING_SHARDS sequence shards with ``ring_flash``
    (the main path, whose launches are counted), beside the unsharded
    flash step and the plain ring at the same batch; ``cfg`` None is
    llama3-8b widths at 4 layers (phase 9r), an MLA config runs its direct
    form through the ring (row 16 at D = 192, phase 9mr)."""
    from k8s_runpod_kubelet_tpu_torch.models import llama3_8b
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, synthetic_batches)

    cfg = cfg or dataclasses.replace(llama3_8b(), n_layers=4)
    n, layers = RING_SHARDS, cfg.n_layers
    layer_norms = 2 + (cfg.is_mla + (cfg.mla_q_lora_rank is not None))
    mesh = make_mesh(MeshConfig(seq=n))
    tc = TrainConfig(batch_size=RING_BATCH, seq_len=RING_SEQ, steps=steps,
                     warmup_steps=1)
    batch = next(synthetic_batches(cfg, tc, seed=SEED, device=dev))
    checks = ring_checks(torch, dev, cfg, mesh, batch)
    ring_cfg = dataclasses.replace(cfg, ring_flash=True)
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    # a ring step of a layer is one launch of each kernel (the shards
    # stacked), forward twice under remat
    per_step = {"flash_fwd": 2 * n * layers, "flash_dq": n * layers,
                "flash_dkv": n * layers,
                "rms_norm": 2 * (layer_norms * layers) + 1}
    trainer = Trainer(ring_cfg, tc, seed=SEED, device=dev, mesh=mesh)
    # the main path: counts set to 0 just before the run, read just after
    for k in kernels:
        k.launches = 0
    ring = timed_steps(torch, trainer, itertools.repeat(batch), tc.steps,
                       kernels, per_step)
    launches = {k.__name__: k.launches for k in kernels}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    if not ring["losses"][-1] < ring["losses"][0]:
        raise RuntimeError(f"the ring's loss did not fall: {ring['losses']}")
    step1_rel = (abs(ring["grad_norms"][0] - checks["ref_grad_norm"])
                 / checks["ref_grad_norm"])
    if not step1_rel <= TRAIN_NORM_REL_LIMIT:
        raise RuntimeError(f"ring step 1's grad_norm {ring['grad_norms'][0]}"
                           f" is off the plain forward's "
                           f"{checks['ref_grad_norm']}")
    runs = {"ring_flash": ring}
    for name, run_cfg, run_mesh in (("unsharded_flash", cfg, None),
                                    ("plain_ring", cfg, mesh)):
        trainer = Trainer(run_cfg, tc, seed=SEED, device=dev, mesh=run_mesh)
        runs[name] = timed_steps(torch, trainer, itertools.repeat(batch), 3)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    plain_rel = (abs(runs["plain_ring"]["losses"][0] - ring["losses"][0])
                 / ring["losses"][0])
    for name, r in runs.items():
        log(f"  [{card}] {name}: step wall {r['step_s_median']:.3f} s "
            f"(median of steps 2-{r['steps']}; first "
            f"{r['step_walls_s'][0]:.3f} s), {r['tokens_per_s']:.0f} "
            f"tokens/s, peak {r['peak_bytes'] / 2**30:.2f} GiB; losses "
            + ", ".join(f"{x:.4f}" for x in r["losses"]))
    log(f"  ring step 1 grad_norm {ring['grad_norms'][0]:.5f} vs the plain "
        f"f32 forward's {checks['ref_grad_norm']:.5f}: rel {step1_rel:.2e}; "
        f"plain ring step 1 loss rel {plain_rel:.2e} of the flash ring's "
        f"(limit {RING_PLAIN_LOSS_REL_LIMIT})")
    log(f"  launches over {tc.steps} steps: {launches} ({per_step} per step)")
    if not plain_rel <= RING_PLAIN_LOSS_REL_LIMIT:
        raise RuntimeError(f"the plain ring's loss {runs['plain_ring']} is "
                           f"off the flash ring's {ring['losses']}")
    return {"model": cfg.name, "layers": layers, "shards": n,
            "batch": tc.batch_size, "seq_len": tc.seq_len, "runs": runs,
            "checks": checks,
            "launches": launches, "launches_per_step": per_step,
            "step1_norm_rel_err": step1_rel, "plain_ring_loss_rel": plain_rel}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def train_main_phase(torch) -> dict:
    import contextlib
    import io

    from k8s_runpod_kubelet_tpu_torch.workloads import train_main

    cap = _Capture()
    train_log = logging.getLogger("k8s_runpod_kubelet_tpu_torch.workloads")
    train_log.addHandler(cap)
    train_log.setLevel(logging.INFO)
    outs = []
    try:
        with tempfile.TemporaryDirectory() as ckpt:
            for _ in range(2):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = train_main.main(["--model", "tiny", "--steps", "2",
                                          "--checkpoint-dir", ckpt])
                if rc != 0:
                    raise RuntimeError(f"train_main exited {rc}")
                outs.append(json.loads(buf.getvalue().strip()
                                       .splitlines()[-1]))
    finally:
        train_log.removeHandler(cap)
    if "resumed from checkpoint step 2" not in cap.lines:
        raise RuntimeError(f"the second life did not resume: {cap.lines}")
    for out in outs:
        if not (out["workload"] == "pretrain" and out["steps"] == 2
                and math.isfinite(out["final_loss"])):
            raise RuntimeError(f"train_main printed {out}")
    log(f"  train_main --model tiny --steps 2, twice: losses "
        f"{outs[0]['final_loss']:.4f} then {outs[1]['final_loss']:.4f}; "
        f"logged {[x for x in cap.lines if 'checkpoint' in x]}")
    return {"summaries": outs, "log": cap.lines}


# -- phase 9f: the fine-tune workload -----------------------------------------------


def fused_and_dots_phase(torch, dev, card: str) -> dict:
    """Phase 9f (a) and (b) on phase 9's configuration (llama3-8b widths, 4
    layers, batch 8 x 2048, its seeded batch), two steps a run from the
    same seeded params: the naive loss under remat "full", the fused loss
    over FT_CHUNKS vocab chunks under "full", and the fused loss under
    "dots". (a) step 1's loss and grad norm fused against naive within
    TRAIN_NORM_REL_LIMIT, and the fused peak below the naive one by at
    least the bf16 logits' B x S x V x 2 bytes; (b) "dots" against "full"
    within the same limit, the launches a step exact and equal (flash_fwd
    2L: "dots" recomputes the flash forward as "full" does)."""
    from k8s_runpod_kubelet_tpu_torch.models import llama3_8b
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, synthetic_batches)

    cfg = dataclasses.replace(llama3_8b(), n_layers=4)
    n = cfg.n_layers
    tc = TrainConfig(batch_size=8, seq_len=2048, steps=2, warmup_steps=1)
    batch = next(synthetic_batches(cfg, tc, seed=SEED, device=dev))
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n,
                "rms_norm": 4 * n + 1}
    runs = {}
    for name, chunks, policy in (("naive", 0, "full"),
                                 ("fused", FT_CHUNKS, "full"),
                                 ("fused_dots", FT_CHUNKS, "dots")):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(dataclasses.replace(cfg, remat_policy=policy),
                          dataclasses.replace(tc, fused_ce_chunks=chunks),
                          seed=SEED, device=dev)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        # each run is a path of its own: counts set to 0 just before it
        for k in kernels:
            k.launches = 0
        run = timed_steps(torch, trainer, itertools.repeat(batch), tc.steps,
                          kernels, per_step)
        run.update(launches={k.__name__: k.launches for k in kernels},
                   resident_bytes=resident, remat_policy=policy,
                   fused_ce_chunks=chunks)
        runs[name] = run
        log(f"  [{card}] {name} (remat {policy}, fused_ce_chunks {chunks}): "
            f"step walls {[round(w, 4) for w in run['step_walls_s']]} s, "
            f"peak {run['peak_bytes'] / 2**30:.2f} GiB allocated (params "
            f"and Adam state {resident / 2**30:.2f} GiB); launches "
            f"{run['launches']}")
        del trainer
    gc.collect()
    torch.cuda.empty_cache()

    def rel(a, b, key):
        return abs(a[key][0] - b[key][0]) / abs(b[key][0])

    naive, fused, dots = runs["naive"], runs["fused"], runs["fused_dots"]
    logits_bf16 = tc.batch_size * tc.seq_len * cfg.vocab_size * 2
    saved = naive["peak_bytes"] - fused["peak_bytes"]
    out = {"runs": runs, "logits_bf16_bytes": logits_bf16,
           "logits_f32_bytes": 2 * logits_bf16, "peak_saved_bytes": saved,
           "fused_vs_naive": {"loss_rel": rel(fused, naive, "losses"),
                              "grad_norm_rel": rel(fused, naive,
                                                   "grad_norms")},
           "dots_vs_full": {"loss_rel": rel(dots, fused, "losses"),
                            "grad_norm_rel": rel(dots, fused, "grad_norms")},
           "limit_rel": TRAIN_NORM_REL_LIMIT,
           "launches_per_step": per_step}
    log(f"  (a) [{card}] step 1 fused vs naive: loss rel "
        f"{out['fused_vs_naive']['loss_rel']:.2e}, grad_norm rel "
        f"{out['fused_vs_naive']['grad_norm_rel']:.2e} (limit "
        f"{TRAIN_NORM_REL_LIMIT}); peak {naive['peak_bytes'] / 2**30:.2f} -> "
        f"{fused['peak_bytes'] / 2**30:.2f} GiB: {saved / 1e9:.2f} GB saved "
        f"(B x S x V x 2 = {logits_bf16 / 1e9:.2f} GB required, x 4 = "
        f"{2 * logits_bf16 / 1e9:.2f} GB); step 2 wall "
        f"{naive['step_walls_s'][1]:.4f} -> {fused['step_walls_s'][1]:.4f} s")
    log(f"  (b) [{card}] step 1 dots vs full (both fused): loss rel "
        f"{out['dots_vs_full']['loss_rel']:.2e}, grad_norm rel "
        f"{out['dots_vs_full']['grad_norm_rel']:.2e}; step 2 wall "
        f"{fused['step_walls_s'][1]:.4f} (full) vs "
        f"{dots['step_walls_s'][1]:.4f} s (dots); peak "
        f"{fused['peak_bytes'] / 2**30:.2f} vs "
        f"{dots['peak_bytes'] / 2**30:.2f} GiB; launches a step {per_step} "
        f"under both")
    for what, r in (("fused_vs_naive", out["fused_vs_naive"]),
                    ("dots_vs_full", out["dots_vs_full"])):
        if not max(r.values()) <= TRAIN_NORM_REL_LIMIT:
            raise RuntimeError(f"{what}: step 1 off by {r}")
    if not saved >= logits_bf16:
        raise RuntimeError(f"the fused loss saved {saved} bytes of peak, "
                           f"less than the bf16 logits' {logits_bf16}")
    if dots["launches"] != fused["launches"]:
        raise RuntimeError(f"dots launched {dots['launches']}, full "
                           f"{fused['launches']}")
    return out


class _Tee:
    """A text stream that writes through to ``real`` and keeps the lines
    (the training run's protocol lines on stderr)."""

    def __init__(self, real):
        self.real = real
        self.lines: list[str] = []
        self._part = ""

    def write(self, text: str) -> int:
        self.real.write(text)
        *done, self._part = (self._part + text).split("\n")
        self.lines += done
        return len(text)

    def flush(self):
        self.real.flush()


def leaf_checksums(torch, tree: dict, frozen_only: bool,
                   prefix: str = "") -> dict:
    """The trainer's ``bits_sum`` (a position-weighted sum of the raw bits,
    on the card) of each leaf, or each frozen one, by path."""
    from k8s_runpod_kubelet_tpu_torch.workloads.train import bits_sum

    out = {}
    for name in sorted(tree):
        leaf = tree[name]
        if isinstance(leaf, dict):
            out.update(leaf_checksums(torch, leaf, frozen_only,
                                      f"{prefix}{name}/"))
        elif not (frozen_only and leaf.requires_grad):
            out[prefix + name] = bits_sum(leaf)
    return out


def http_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


TRAIN_SERIES = ("tpu_training_step_seconds_bucket",
                "tpu_training_tokens_per_second", "tpu_training_mfu_ratio",
                "tpu_training_goodput_ratio", "tpu_training_last_step")


def scrape_training(port: int, stop: threading.Event, out: list) -> None:
    """While the run trains: /debug/train, /metrics, /debug/train again,
    every 0.25 s; a triple whose two snapshots name one step is kept (the
    last 64). Refused connections before the server is up are retried."""
    base = f"http://127.0.0.1:{port}"
    while not stop.wait(0.25):
        try:
            s1 = json.loads(http_json(base + "/debug/train"))
            text = http_json(base + "/metrics")
            s2 = json.loads(http_json(base + "/debug/train"))
        except (urllib.error.URLError, ConnectionError):
            continue
        if s1["step"] == s2["step"]:
            m = re.search(r"^tpu_training_last_step (\S+)$", text, re.M)
            out.append({"step": s1["step"],
                        "last_step_gauge": float(m.group(1)) if m else None,
                        "series": [k for k in TRAIN_SERIES if k in text]})
            del out[:-64]


def interrupted_write_check(torch, dev) -> dict:
    """(e): on the card, a tiny trainer saves step 1, then a staged save of
    step 2 whose writer raises before its rename (a torn temporary file):
    the wait raises, no temporary file is left, and a fresh trainer
    restores step 1 bit for bit."""
    from k8s_runpod_kubelet_tpu_torch.models import tiny_llama
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, synthetic_batches)

    cfg = tiny_llama(n_layers=2)
    with tempfile.TemporaryDirectory() as ck:
        tc = TrainConfig(batch_size=2, seq_len=64, steps=2, warmup_steps=1,
                         checkpoint_dir=ck)
        a = Trainer(cfg, tc, seed=SEED, device=dev)
        batches = synthetic_batches(cfg, tc, seed=SEED, device=dev)
        a.run(steps=1, batches=batches)
        a.save()
        saved = leaf_checksums(torch, a.params, frozen_only=False)
        a.run(steps=1, batches=batches)

        def torn(tmp):
            with open(tmp, "r+b") as f:
                f.truncate(4096)
            raise OSError("the write was interrupted")

        a.checkpoints.before_rename = torn
        a.save(block=False)
        try:
            a.wait_pending()
        except RuntimeError as e:
            error = f"{e} ({e.__cause__!r})"
        else:
            raise RuntimeError("the interrupted write did not fail the save")
        left = sorted(os.listdir(ck))
        b = Trainer(cfg, tc, seed=SEED + 1, device=dev)
        if not (b.restore() and b.step == 1):
            raise RuntimeError(f"no step-1 checkpoint after the torn write: "
                               f"{left}")
        same = leaf_checksums(torch, b.params, frozen_only=False) == saved
        if left != ["step_00000001.pt"] or not same:
            raise RuntimeError(f"after the torn write: files {left}, "
                               f"restored bit-identical {same}")
        n = len(_leaves(b.params))
    log(f"  (e) a staged save whose writer raised: {error!s:.80}; files "
        f"left {left}; step 1 restored bit-identical ({n} leaves)")
    return {"error": error, "files": left, "restored_identical": same}


def serve_trained_adapter(torch, dev, card: str, cfg, base: dict,
                          adapter_path: str, prompt: list) -> dict:
    """(f): the exported adapter registered on a paged engine over the
    fine-tune's bf16 base (``serve_main --lora-rank 16``, 2 slots), one
    greedy request of FT_SERVE_TOKENS tokens under it, with row 8 and row
    12 launches exact a step or chunk; the tokens against the argmax of a
    plain f32 forward of ``merge_lora`` of the same base and adapter over
    the prompt and the engine's tokens (a differing position must be a
    near tie: its top-2 margin under SPEC_TIE_MARGIN of the logits' RMS).
    The base's own forward is printed beside it (how far the adapter moves
    the logits)."""
    from k8s_runpod_kubelet_tpu_torch.models.lora import (load_adapter,
                                                          merge_lora)
    from k8s_runpod_kubelet_tpu_torch.ops import paged_attention_multi, rms_norm
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    adapter = load_adapter(adapter_path)
    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "2",
         "--cache-len", "1024", "--max-new-tokens", str(FT_SERVE_TOKENS),
         "--lora-rank", str(FT_RANK), "--lora-targets", ",".join(adapter),
         "--max-adapters", "1"])
    engine, _ = serve_main.build_engine(args, base)
    kernels = (paged_attention_multi, rms_norm)
    try:
        engine.register_adapter("ft", adapter)
        c0 = dict(engine.counters)
        l0 = {k.__name__: k.launches for k in kernels}
        res = engine.submit(prompt, max_new_tokens=FT_SERVE_TOKENS,
                            adapter="ft").result(timeout=600)
        wait_for(lambda: engine.active_slots == 0, "the engine idle", 60)
        steps = ((engine.counters["decode_steps"] - c0["decode_steps"])
                 + (engine.counters["paged_prefill_chunks"]
                    - c0["paged_prefill_chunks"]))
        launches = {k.__name__: k.launches - l0[k.__name__] for k in kernels}
    finally:
        engine.stop()
    want = {"paged_attention_multi": cfg.n_layers * steps,
            "rms_norm": (2 * cfg.n_layers + 1) * steps}
    if launches != want:
        raise RuntimeError(f"(f) launches {launches}, not {want} for "
                           f"{steps} steps and chunks")
    tokens = res["tokens"]
    wrapped = dict(base)
    wrapped["layers"] = dict(base["layers"])
    for t, ad in adapter.items():
        wrapped["layers"][t] = {
            "w": base["layers"][t],
            **{k: torch.from_numpy(ad[src]).to(dev) for k, src in
               (("lora_a", "a"), ("lora_b", "b"), ("scale", "scale"))}}
    merged = merge_lora(wrapped)
    seq = torch.tensor([prompt + tokens[:-1]], device=dev)
    with torch.no_grad():
        ref = plain_logits(torch, cfg, merged, seq)[0, len(prompt) - 1:]
        plain_base = plain_logits(torch, cfg, base, seq)[0, len(prompt) - 1:]
    del merged, wrapped
    picks = ref.argmax(-1).tolist()
    ties = []
    for i, (got, pick) in enumerate(zip(tokens, picks)):
        if got == pick:
            continue
        top2 = ref[i].topk(2).values
        margin = (top2[0] - top2[1]).item()
        rms = ref[i].pow(2).mean().sqrt().item()
        ties.append({"at": i, "margin_share": margin / rms})
        if not margin < SPEC_TIE_MARGIN * rms:
            raise RuntimeError(f"(f) the adapter's token {i} is {got}, the "
                               f"merged forward's argmax {pick}, top-2 "
                               f"margin {margin / rms:.3f} of the RMS")
    moved = ((ref - plain_base).norm() / plain_base.norm()).item()
    base_picks = plain_base.argmax(-1).tolist()
    out = {"tokens": tokens, "merged_argmax": picks, "near_ties": ties,
           "launches": launches, "steps_and_chunks": steps,
           "adapter_moves_logits_rel_l2": moved,
           "base_argmax_differs_at": [i for i, (a, b) in enumerate(
               zip(picks, base_picks)) if a != b],
           "tie_margin": SPEC_TIE_MARGIN}
    log(f"  (f) [{card}] adapter 'ft' served on the paged engine: "
        f"{FT_SERVE_TOKENS} greedy tokens {tokens}; merged f32 forward's "
        f"argmax {picks} ({len(ties)} near ties {ties}); the adapter moves "
        f"the f32 logits by {moved:.4f} relative L2 (base argmax differs at "
        f"{out['base_argmax_differs_at']}); launches {launches} over "
        f"{steps} steps and chunks")
    return out


def watched_trainer(torch, base, kernels, made: list):
    """The trainer class train_main builds (``base``), watched: the init's
    peak memory, the frozen leaves' checksums at init, each step's wall
    (the step call through its loss on the host), loss, router aux and
    launches of the ``kernels`` wrappers, and every leaf's checksum right
    after a restore; each instance is appended to ``made``."""

    class Watched(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            # the init's peak apart from the steps' (a LoRA run draws its
            # frozen leaves straight into bf16)
            self.init_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            self.init_sums = leaf_checksums(torch, self.params, True)
            self.walls, self.losses, self.launches = [], [], []
            self.auxes = []
            self.restored_sums = None
            inner = self.step_fn

            def step_fn(params, opt_state, batch):
                before = {k.__name__: k.launches for k in kernels}
                t = time.perf_counter()
                out = inner(params, opt_state, batch)
                self.losses.append(float(out["loss"]))
                self.walls.append(time.perf_counter() - t)
                self.auxes.append(float(out["aux_loss"]))
                self.launches.append({k.__name__: k.launches
                                      - before[k.__name__] for k in kernels})
                return out

            self.step_fn = step_fn
            made.append(self)

        def restore(self):
            ok = super().restore()
            self.restored_sums = leaf_checksums(torch, self.params, False)
            return ok

    return Watched


def finetune_phase(torch, dev, card: str) -> dict:
    """Phase 9f (c)-(f): a LoRA fine-tune of the whole llama3-8b (32
    layers, random init from train_main's seed) through
    ``train_main.main``, then its resume, a torn write, and the exported
    adapter served (module docstring, phase 9f)."""
    import contextlib
    import io
    import socket

    import numpy as np

    from k8s_runpod_kubelet_tpu_torch import data as data_pkg
    from k8s_runpod_kubelet_tpu_torch.models import llama3_8b
    from k8s_runpod_kubelet_tpu_torch.models.lora import lora_param_count
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import train as train_mod
    from k8s_runpod_kubelet_tpu_torch.workloads import train_main
    from k8s_runpod_kubelet_tpu_torch.workloads.telemetry import (
        parse_heartbeat, parse_telemetry)

    cfg = llama3_8b()
    n = cfg.n_layers
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n,
                "rms_norm": 4 * n + 1}
    made: list = []
    Watched = watched_trainer(torch, train_mod.Trainer, kernels, made)

    loaders: list = []
    real_make_loader = data_pkg.make_loader

    def make_loader(*a, **kw):
        loaders.append(real_make_loader(*a, **kw))
        return loaders[-1]

    cap = _Capture()
    watched_logs = [logging.getLogger("train-main"),
                    logging.getLogger("k8s_runpod_kubelet_tpu_torch.workloads")]
    for lg in watched_logs:
        lg.addHandler(cap)
        lg.setLevel(logging.INFO)
    train_mod.Trainer, real_trainer = Watched, train_mod.Trainer
    data_pkg.make_loader = make_loader
    out: dict = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(SEED)
            pattern = rng.integers(0, cfg.vocab_size, FT_PATTERN)
            data = os.path.join(tmp, "tokens.bin")
            np.resize(pattern, FT_WINDOWS * FT_SEQ + 1).astype("<i4") \
                .tofile(data)
            ck = os.path.join(tmp, "ck")
            adapter_path = os.path.join(tmp, "ft_adapter.npz")
            profile_dir = os.path.join(tmp, "profile")
            argv = ["--model", cfg.name, "--lora-rank", str(FT_RANK),
                    "--fused-ce-chunks", str(FT_CHUNKS), "--batch",
                    str(FT_BATCH), "--seq-len", str(FT_SEQ), "--lr",
                    str(FT_LR), "--data", data, "--checkpoint-dir", ck,
                    "--checkpoint-every", str(FT_EVERY)]
            # -- (c), (d): the fine-tune, its telemetry scraped as it runs.
            # The port is free when picked; should another process take it
            # before the server binds (which comes before any training),
            # main raises EADDRINUSE and the run starts again on another
            for attempt in range(FT_PORT_TRIES):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                scrapes: list = []
                stop = threading.Event()
                scraper = threading.Thread(target=scrape_training,
                                           args=(port, stop, scrapes),
                                           daemon=True)
                stdout, tee = io.StringIO(), _Tee(sys.stderr)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for k in kernels:
                    k.launches = 0
                scraper.start()
                t0 = time.perf_counter()
                try:
                    with contextlib.redirect_stdout(stdout), \
                            contextlib.redirect_stderr(tee):
                        rc = train_main.main(argv + [
                            "--steps", str(FT_STEPS), "--telemetry-port",
                            str(port), "--telemetry-every", "1",
                            "--export-adapter", adapter_path,
                            "--profile-dir", profile_dir])
                except OSError as e:
                    if (e.errno != errno.EADDRINUSE or made
                            or attempt + 1 == FT_PORT_TRIES):
                        raise
                    print(f"  9f: port {port} taken before the telemetry "
                          "server bound it; another port", flush=True)
                    continue
                finally:
                    stop.set()
                    scraper.join(timeout=30)
                break
            main_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            peak = torch.cuda.max_memory_allocated()
            if rc != 0 or len(made) != 1:
                raise RuntimeError(f"train_main exited {rc}, {len(made)} "
                                   "trainers")
            summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
            tr = made[0]
            out["finetune"] = finetune_checks(
                torch, card, cfg, tr, summary, launches, per_step, peak,
                main_s, cap.lines, loaders, lora_param_count)
            out["finetune"]["profile"] = profile_dir_checks(
                card, os.path.join(profile_dir, train_main.PROFILE_TRACE),
                per_step, tr.walls)
            out["telemetry"] = telemetry_checks(
                torch, card, cfg, tr, tee.lines, scrapes, ck,
                parse_heartbeat, parse_telemetry)
            out["async_checkpoint"] = {
                "files": sorted(os.listdir(ck)),
                "step4_wall_s": tr.walls[3], "step2_wall_s": tr.walls[1]}
            for marker in (f"checkpoint staged at step {FT_EVERY} (write in "
                           "background)",
                           f"checkpoint staged at step {FT_STEPS} (write in "
                           "background)",
                           f"checkpoint saved at step {FT_EVERY}",
                           f"checkpoint saved at step {FT_STEPS}"):
                if marker not in cap.lines:
                    raise RuntimeError(f"(e) no {marker!r} in {cap.lines}")
            # durable before the run returned: the last save landed before
            # the adapter export that follows the run
            at = cap.lines.index(f"checkpoint saved at step {FT_STEPS}")
            exported = next(i for i, ln in enumerate(cap.lines)
                            if ln.startswith("adapter written to"))
            if not at < exported:
                raise RuntimeError(f"(e) the step-{FT_STEPS} write landed "
                                   "after the run returned")
            log(f"  (e) [{card}] async saves at steps {FT_EVERY} and "
                f"{FT_STEPS} staged, then durable before the run returned; "
                f"step 4 (beside the step-{FT_EVERY} write) "
                f"{tr.walls[3]:.4f} s against step 2 {tr.walls[1]:.4f} s; "
                f"files {out['async_checkpoint']['files']}")
            final_sums = leaf_checksums(torch, tr.params, False)
            del tr
            made.clear()
            gc.collect()
            torch.cuda.empty_cache()
            # -- (e): a second life resumes at step FT_STEPS
            cap.lines.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(_Tee(sys.stderr)):
                rc = train_main.main(argv + ["--steps", "1"])
            resume_s = time.perf_counter() - t0
            tr2 = made[0]
            marker = f"resumed from checkpoint step {FT_STEPS}"
            if rc != 0 or marker not in cap.lines:
                raise RuntimeError(f"(e) the second life: rc {rc}, logged "
                                   f"{cap.lines}")
            if tr2.restored_sums != final_sums:
                bad = [k for k in final_sums
                       if tr2.restored_sums.get(k) != final_sums[k]]
                raise RuntimeError(f"(e) restored leaves differ: {bad}")
            out["async_checkpoint"].update(
                resumed=True, restored_leaves=len(final_sums),
                resume_s=resume_s)
            log(f"  (e) [{card}] a second train_main logged {marker!r}; all "
                f"{len(final_sums)} leaves bit-identical to the first run's "
                f"last; it ran one step and saved ({resume_s:.1f} s)")
            out["async_checkpoint"]["interrupted"] = interrupted_write_check(
                torch, dev)
            # -- (f): the exported adapter on the paged engine, over the
            # frozen bf16 base both lives share
            base = {k: v.detach() for k, v in tr2.params.items()
                    if k != "layers"}
            base["layers"] = {k: (v["w"] if isinstance(v, dict) else v)
                              .detach()
                              for k, v in tr2.params["layers"].items()}
            del tr2
            made.clear()
            gc.collect()
            torch.cuda.empty_cache()
            prompt = np.resize(pattern, 3 * FT_PATTERN).tolist()
            out["serve"] = serve_trained_adapter(torch, dev, card, cfg, base,
                                                 adapter_path, prompt)
            del base
    finally:
        train_mod.Trainer = real_trainer
        data_pkg.make_loader = real_make_loader
        for lg in watched_logs:
            lg.removeHandler(cap)
        made.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def finetune_checks(torch, card, cfg, tr, summary, launches, per_step, peak,
                    main_s, lines, loaders, lora_param_count) -> dict:
    """(c): loss falls; frozen leaves bit-identical; Adam state only on the
    LoRA leaves; the logged trainable count; peak within the card; launches
    exact a step; the native loader read the data."""
    if not tr.losses[-1] < tr.losses[0]:
        raise RuntimeError(f"(c) the loss did not fall: {tr.losses}")
    after = leaf_checksums(torch, tr.params, True)
    if after != tr.init_sums:
        bad = [k for k in after if after[k] != tr.init_sums.get(k)]
        raise RuntimeError(f"(c) frozen leaves changed: {bad}")
    moment_paths = list(leaf_checksums(torch, tr.opt_state["mu"], False))
    if not moment_paths or not all(p.endswith(("/lora_a", "/lora_b"))
                                   for p in moment_paths):
        raise RuntimeError(f"(c) Adam moments on {moment_paths}")
    from k8s_runpod_kubelet_tpu_torch.workloads.train import _leaves
    adam_bytes = sum(t.numel() * t.element_size() for t in
                     _leaves(tr.opt_state["mu"]) + _leaves(tr.opt_state["nu"]))
    trainable = lora_param_count(tr.params)
    logged = next((ln for ln in lines if ln.startswith("LoRA r=")), "")
    m = re.match(r"LoRA r=(\d+): ([0-9.]+)M trainable of ([0-9.]+)B total",
                 logged)
    if not m or float(m.group(2)) != round(trainable / 1e6, 2):
        raise RuntimeError(f"(c) the trainable-count line {logged!r} against "
                           f"{trainable}")
    if not max(peak, tr.init_peak) <= CARD_BYTES:
        raise RuntimeError(f"(c) peak {peak} bytes (init {tr.init_peak}) "
                           "does not fit the card")
    for i, got in enumerate(tr.launches):
        if got != per_step:
            raise RuntimeError(f"(c) step {i + 1} launched {got}, not "
                               f"{per_step}")
    if launches != {k: v * FT_STEPS for k, v in per_step.items()}:
        raise RuntimeError(f"(c) launches over the run {launches}")
    kinds = [type(x).__name__ for x in loaders]
    if kinds != ["NativeTokenLoader"]:
        raise RuntimeError(f"(c) the data went through {kinds}")
    # the untraced steps after the first (--profile-dir traces FT_TRACED)
    untraced = [w for i, w in enumerate(tr.walls[1:], 2)
                if i not in FT_TRACED]
    step_s = statistics.median(untraced)
    tok_s = FT_BATCH * FT_SEQ / step_s
    frozen_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(tr.params) if not t.requires_grad)
    out = {"losses": tr.losses, "step_walls_s": tr.walls,
           "step_s_median": step_s, "untraced_steps_s": untraced,
           "tokens_per_s": tok_s,
           "peak_bytes": peak, "init_peak_bytes": tr.init_peak,
           "adam_bytes": adam_bytes,
           "trainable_params": trainable, "logged": logged,
           "frozen_bytes": frozen_bytes, "launches": launches,
           "launches_per_step": per_step, "summary": summary,
           "main_s": main_s, "loader": kinds[0]}
    log(f"  (c) [{card}] llama3-8b ({cfg.n_layers} layers) LoRA r={FT_RANK} "
        f"on wq, wv through train_main from a token file "
        f"({kinds[0]}): losses {[round(x, 4) for x in tr.losses]}; step "
        f"walls {[round(w, 4) for w in tr.walls]} s (steps {FT_TRACED} "
        f"traced), median of the untraced steps after the first "
        f"{step_s:.4f} s, {tok_s:.0f} tokens/s; {logged!r}; Adam "
        f"state {adam_bytes / 1e6:.1f} MB on {len(moment_paths)} LoRA "
        f"leaves; frozen leaves {frozen_bytes / 2**30:.2f} GiB, all "
        f"bit-identical after the run; peak {peak / 2**30:.2f} GiB "
        f"allocated over the steps, saves and export ({tr.init_peak / 2**30:.2f}"
        f" GiB in the init); launches a step {per_step}; "
        f"train_main {main_s:.1f} s")
    return out


def profile_dir_checks(card, trace: str, per_step: dict, walls) -> dict:
    """(c)'s ``--profile-dir``: the trace holds exactly the FT_TRACED steps
    (their ``train_step`` ranges, and the kernels of rows 1-3 and 12 at
    that many steps' launches, none over and at most FT_TRACE_LOST
    records of a family lost), and the untraced steps after the first
    stay within FT_UNTRACED_REL of FT_BASE_STEP_S."""
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import (
        trace_kernel_events)
    from k8s_runpod_kubelet_tpu_torch.workloads.train import STEP_RANGE

    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    # the host's ranges (a CUDA trace repeats each as a
    # gpu_user_annotation over its kernels)
    ranges = sum(1 for e in events if e.get("name") == STEP_RANGE
                 and e.get("cat") == "user_annotation")
    del events
    fams = trace_kernel_events(trace)
    n = len(FT_TRACED)
    counts = {k: fams.get(k, {}).get("count", 0) for k in per_step}
    want = {k: v * n for k, v in per_step.items()}
    untraced = [w for i, w in enumerate(walls[1:], 2) if i not in FT_TRACED]
    median = statistics.median(untraced)
    rel = median / FT_BASE_STEP_S - 1
    lost = {k: want[k] - counts[k] for k in want}
    out = {"trace_bytes": os.path.getsize(trace), "step_ranges": ranges,
           "kernel_events": counts, "want": want, "records_lost": lost,
           "device_ms": {k: fams.get(k, {}).get("ms", 0.0) for k in per_step},
           "untraced_steps_s": untraced, "untraced_median_s": median,
           "vs_unprofiled": rel, "limit_rel": FT_UNTRACED_REL}
    log(f"  (c) --profile-dir [{card}]: a {out['trace_bytes'] / 1e6:.1f} MB "
        f"trace with {ranges} train_step ranges; kernel events {counts} "
        f"(want {want}; records lost {lost}), device ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["device_ms"].items())
        + f"; untraced steps after the first {[round(w, 4) for w in untraced]}"
        f" s, median {median:.4f} s, {rel:+.2%} against the unprofiled "
        f"{FT_BASE_STEP_S} s (limit {FT_UNTRACED_REL:.0%})")
    if ranges != n or not all(0 <= v <= FT_TRACE_LOST
                                  for v in lost.values()):
        raise RuntimeError(f"(c) the trace holds {ranges} steps and {counts}"
                           f", not {n} steps' {want}")
    if not abs(rel) <= FT_UNTRACED_REL:
        raise RuntimeError(f"(c) untraced steps {untraced}: median "
                           f"{median:.4f} s, {rel:+.2%} off the unprofiled "
                           f"{FT_BASE_STEP_S} s")
    return out


def telemetry_checks(torch, card, cfg, tr, lines, scrapes, ck,
                     parse_heartbeat, parse_telemetry) -> dict:
    """(d): one heartbeat a step within FT_HEARTBEAT_REL of the phase's own
    wall; the last TPU_TELEMETRY line at the last step with goodput in (0,
    1] and the MFU of the h100 peak; exposure 0 once the final save is
    durable (the telemetry and its state file); a scrape during the run
    whose /metrics step equals /debug/train's; the final snapshot's
    buckets summing to its wall within 1 ms."""
    from k8s_runpod_kubelet_tpu_torch.generations import peak_tflops_per_chip

    beats = [parse_heartbeat(ln) for ln in lines
             if ln.startswith("TPU_STEP_HEARTBEAT")]
    if [b[1] for b in beats] != list(range(1, FT_STEPS + 1)):
        raise RuntimeError(f"(d) heartbeats {beats}")
    rels = [abs(b[2] - w) / w for b, w in zip(beats, tr.walls)]
    if not max(rels) <= FT_HEARTBEAT_REL:
        raise RuntimeError(f"(d) heartbeat step times {[b[2] for b in beats]}"
                           f" against the walls {tr.walls}")
    states = [parse_telemetry(ln) for ln in lines
              if ln.startswith("TPU_TELEMETRY ")]
    last = states[-1]
    peak = peak_tflops_per_chip(torch.cuda.get_device_name(0))
    mfu = 6.0 * cfg.param_count * last["tokens_per_sec"] / (peak * 1e12)
    if not (last["step"] == FT_STEPS and 0 < last["goodput"] <= 1
            and last["mfu"] > 0 and abs(last["mfu"] - mfu) <= 2e-6
            and peak == 989.0):
        raise RuntimeError(f"(d) the last TPU_TELEMETRY line {last} (MFU at "
                           f"the {peak} TFLOP/s peak: {mfu})")
    exposure = tr.telemetry.telemetry_payload()["unsaved_work_s"]
    with open(os.path.join(ck, "goodput_state.json")) as f:
        state = json.load(f)
    if not (exposure <= 1e-3 and state["unsaved_work_s"] == 0.0
            and state["step"] == FT_STEPS):
        raise RuntimeError(f"(d) exposure after the final durable save "
                           f"{exposure}, state file {state}")
    good = [s for s in scrapes if s["step"] >= 1
            and s["last_step_gauge"] == float(s["step"])
            and len(s["series"]) == len(TRAIN_SERIES)]
    if not good:
        raise RuntimeError(f"(d) no consistent scrape during the run: "
                           f"{scrapes[-4:]}")
    snap = tr.telemetry.snapshot()
    drift = abs(sum(snap["buckets"].values()) - snap["wall_s"])
    if not drift <= 1e-3:
        raise RuntimeError(f"(d) buckets {snap['buckets']} against wall "
                           f"{snap['wall_s']}")
    out = {"heartbeats": beats, "heartbeat_rel": rels, "last_line": last,
           "mfu_expected": mfu, "peak_tflops": peak,
           "exposure_after_final_save": exposure, "state_file": state,
           "scrapes": len(scrapes), "consistent_scrapes": len(good),
           "scraped_steps": sorted({s["step"] for s in good}),
           "snapshot": snap, "bucket_sum_drift_s": drift,
           "telemetry_lines": len(states)}
    log(f"  (d) [{card}] {len(beats)} heartbeats, step_time_s within "
        f"{max(rels):.2%} of the phase's walls (limit "
        f"{FT_HEARTBEAT_REL:.0%}); last TPU_TELEMETRY {json.dumps(last)} "
        f"(MFU at the h100 peak, 989 TFLOP/s published: {mfu:.6f}; its "
        f"unsaved_work_s is the wait for the step-{FT_STEPS} write, which "
        f"the loop's end spends as productive, as in the JAX trainer); "
        f"after the final durable save: exposure {exposure}, state file "
        f"{state}; {len(good)} of {len(scrapes)} scrapes consistent at "
        f"steps {out['scraped_steps']}; buckets {snap['buckets']} sum to "
        f"the wall {snap['wall_s']} within {drift * 1e3:.3f} ms")
    return out


# -- phase 9e: MoE training ---------------------------------------------------------

def moe_train_capacity(cfg, tokens: int) -> int:
    """Each expert's buffer rows in a training step of ``tokens`` tokens:
    ceil(k x tokens / X x capacity_factor), at least 4 (the JAX
    ``moe_capacity``, written out here)."""
    return max(4, math.ceil(cfg.n_experts_per_tok * tokens / cfg.n_experts
                            * cfg.capacity_factor))


def plain_keep(torch, chosen, before, cap: int, n_experts: int):
    """Which assignments of ``chosen`` (N, k) fit their expert's buffer:
    an assignment's place is the count of the earlier ones (token, then
    slot order) to the same expert, ``before`` (X,) of them from earlier
    rows; it fits below ``cap``. Returns (keep (N, k), counts after)."""
    flat = chosen.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    place = (torch.cumsum(onehot, 0) - onehot + before).gather(
        1, flat[:, None])[:, 0]
    return (place < cap).view(chosen.shape), before + onehot.sum(0)


def plain_moe_mlp(torch, F, cfg, lp, h, route):
    """A routed layer's MLP as training runs it, in f32 from the layer's
    f32 weights on normed tokens h (N, E): the router's softmax (probs),
    ``route(probs)`` -> (chosen (N, k), keep (N, k)), each expert run on
    the tokens whose kept assignment names it, weighted by the
    probabilities at the chosen experts (renormalized over all k with
    ``router_norm_topk``, dropped ones included), plus DeepSeek's shared
    experts. No buffer, no scatter. Returns (y, probs, logsumexp of the
    router logits)."""
    logits = h @ lp["router"]
    probs = torch.softmax(logits, dim=-1)
    chosen, keep = route(probs)
    weight = torch.gather(probs, -1, chosen)
    if cfg.router_norm_topk:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    weight = weight * keep
    y = torch.zeros_like(h)
    if "ws_gate" in lp:
        y = y + (F.silu(h @ lp["ws_gate"]) * (h @ lp["ws_up"])) @ lp["ws_down"]
    for x in range(cfg.n_experts):
        pick = (chosen == x) & keep
        rows = pick.any(dim=-1).nonzero()[:, 0]
        if not len(rows):
            continue
        hx = h[rows]
        yx = (F.silu(hx @ lp["we_gate"][x]) * (hx @ lp["we_up"][x])) \
            @ lp["we_down"][x]
        y = y.index_add(0, rows, (weight * pick).sum(dim=-1)[rows][:, None]
                        * yx)
    return y, probs, torch.logsumexp(logits, dim=-1)


def plain_moe_row(torch, F, cfg, params, tokens, route):
    """``plain_logits`` of one row (1, S) with each routed layer's MLP by
    ``plain_moe_mlp`` at ``route(j, probs)`` (j the routed layer); returns
    (logits, each routed layer's (probs, logsumexp))."""
    stats = []

    def mlp(layer, lp, h):
        flat = h.reshape(-1, h.shape[-1])
        j = len(stats)
        y, probs, lse = plain_moe_mlp(torch, F, cfg, lp, flat,
                                      lambda pr: route(j, pr))
        stats.append((probs, lse))
        return y.view(h.shape)

    return plain_logits(torch, cfg, params, tokens, mlp=mlp), stats


def plain_moe_choices(torch, cfg, params, batch) -> dict:
    """The plain f32 forward's own routing of ``batch`` (B, S + 1), one row
    at a time in the port's flat (B x S) order, the capacity counts carried
    from row to row: per routed layer the chosen experts (B x S, k), which
    fit (``plain_keep`` at ``moe_train_capacity`` of the whole batch), the
    share of assignments each expert got / k (the aux loss's f), the share
    dropped, and the tokens whose k-th and (k+1)-th probabilities lie
    within MOE_ROUTER_TIE."""
    import torch.nn.functional as F

    k, x = cfg.n_experts_per_tok, cfg.n_experts
    n = cfg.n_layers - cfg.n_dense_prefix
    rows, s = batch.shape[0], batch.shape[1] - 1
    cap = moe_train_capacity(cfg, rows * s)
    dev = batch.device
    counts = [torch.zeros(x, dtype=torch.long, device=dev) for _ in range(n)]
    chosen = [[] for _ in range(n)]
    keep = [[] for _ in range(n)]
    ties = [0] * n

    def route(j, probs):
        top = torch.topk(probs, k + 1, dim=-1)
        ties[j] += int((top.values[:, k - 1] - top.values[:, k]
                        < MOE_ROUTER_TIE).sum())
        idx = top.indices[:, :k]
        kp, counts[j] = plain_keep(torch, idx, counts[j], cap, x)
        chosen[j].append(idx)
        keep[j].append(kp)
        return idx, kp

    with torch.no_grad():
        for r in range(rows):
            plain_moe_row(torch, F, cfg, params, batch[r:r + 1, :-1], route)
    chosen = [torch.cat(c) for c in chosen]
    keep = [torch.cat(c) for c in keep]
    f = [torch.nn.functional.one_hot(c, x).float().sum(1).mean(0) / k
         for c in chosen]
    return {"chosen": chosen, "keep": keep, "f": f, "capacity": cap,
            "drop_share": [1.0 - kp.float().mean().item() for kp in keep],
            "near_ties": ties}


def port_moe_grads(torch, model, params, batch, chunks: int, forced=None,
                   rolled: bool = False) -> dict:
    """``loss_aux_and_grads`` of the port's step on ``batch`` (bf16 through the
    kernels, the trainer's own code) with its routing observed: each
    routed layer's MLP input (the bf16 residual stream, from the forward,
    not the remat recompute) and its chosen experts. With ``forced`` (per
    routed layer (B x S, k)) ``models.moe.route_top_k`` takes those ids in
    place of its own top-k, weighting them by its softmax probabilities
    there as it would; with ``rolled`` each expert's down-projection
    output is rolled by one expert, so every assignment gathers its
    neighbour's rows (the control). The port's ``moe_mlp`` computes its
    capacity, dispatch and drops itself either way."""
    from k8s_runpod_kubelet_tpu_torch.models import moe
    from k8s_runpod_kubelet_tpu_torch.workloads.train import \
        loss_aux_and_grads

    routers = params["layers"]["router"]
    layer_of = {routers[j].data_ptr(): j for j in range(routers.shape[0])}
    current = [None]
    seen_x, chosen = {}, {}
    real_mlp, real_route = model._mlp, moe.route_top_k
    real_matmul = moe._expert_matmul
    e = model.cfg.embed_dim

    def mlp(x, lp, *a, **kw):
        if "router" in lp:
            current[0] = layer_of[lp["router"].data_ptr()]
            seen_x.setdefault(current[0], x.detach())
        return real_mlp(x, lp, *a, **kw)

    def route(logits, k, norm_topk=True):
        j = current[0]
        if forced is None:
            top_p, idx, probs = real_route(logits, k, norm_topk)
        else:
            probs = torch.softmax(logits, dim=-1)
            idx = forced[j]
            top_p = torch.gather(probs, 1, idx)
            if norm_topk:
                top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        chosen.setdefault(j, idx)
        return top_p, idx, probs

    def matmul(x, w, dtype, counts=None):
        y = real_matmul(x, w, dtype, counts)
        return torch.roll(y, 1, dims=0) if y.shape[-1] == e else y

    model._mlp, moe.route_top_k = mlp, route
    if rolled:
        moe._expert_matmul = matmul
    try:
        loss, aux, grads = loss_aux_and_grads(model, params, batch,
                                              fused_ce_chunks=chunks)
    finally:
        del model._mlp
        moe.route_top_k, moe._expert_matmul = real_route, real_matmul
    return {"loss": loss.item(), "aux": aux.item(), "grads": grads,
            "x": seen_x, "chosen": chosen}


def moe_flips(torch, cfg, params, port, plain) -> dict:
    """The unforced port step's expert choices, per routed layer, against
    the f32 router on the port's own MLP input (its bf16 residual stream
    normed in f32, ``_rms_norm_plain``): each choice that differs must lie
    within MOE_ROUTER_TIE of a tie there (the k-th and (k+1)-th
    probabilities), as ``moe_layer_check`` holds the engine's. Counted
    beside: the choices differing from the free-running plain forward's,
    which sees its own hidden states."""
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain

    k, lay = cfg.n_experts_per_tok, params["layers"]
    rows = []
    for j in sorted(port["chosen"]):
        x = port["x"][j].float()
        with torch.no_grad():
            h = _rms_norm_plain(x, lay["mlp_norm"][j], cfg.norm_eps)
            probs = torch.softmax(h.reshape(-1, x.shape[-1])
                                  @ lay["router"][j].float(), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        got = torch.sort(port["chosen"][j], -1).values
        differs = (torch.sort(top.indices[:, :k], -1).values != got).any(-1)
        margin = top.values[:, k - 1] - top.values[:, k]
        free = (torch.sort(plain["chosen"][j], -1).values != got).any(-1)
        rows.append({"layer": j, "flips": int(differs.sum()),
                     "flip_margin_max": (margin[differs].max().item()
                                         if differs.any() else 0.0),
                     "differs_from_free_f32": int(free.sum())})
    return {"layers": rows, "flips": sum(r["flips"] for r in rows),
            "flip_margin_max": max(r["flip_margin_max"] for r in rows),
            "differs_from_free_f32": [r["differs_from_free_f32"]
                                      for r in rows]}


def moe_train_grad_check(torch, dev, cfg, batch, chunks: int) -> dict:
    """Step 1's gradients as the training path computes them (bf16
    through the kernels, remat, the router's aux and z losses, capacity
    drops) against autograd of a plain f32 forward of the same objective
    on the same f32 master params and batch. The two may choose different
    experts near a tie, and a changed choice also moves which later
    assignments drop, so the compared port step takes the plain forward's
    choices (``port_moe_grads`` with ``forced``): pass 1 (``plain_moe_choices``)
    routes the plain forward itself, pass 2 takes its gradients one row at
    a time at those choices, CE / rows + per routed layer aux_coef x X x
    sum_x f_x x (the row's probs summed / (B x S)) + z_coef x (the row's
    logsumexp^2 summed / (B x S)), which over the rows is the objective
    of the whole batch. Each leaf's relative L2 error and the global
    norm's within phase 9's limits; the control (each expert's output
    gathered from its neighbour's rows) must exceed the leaf limit. The
    unforced step (the trainer's own routing) is reported beside, with
    its flips (``moe_flips``), each of which must lie at a near tie."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel, init_params
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (_leaves,
                                                              global_norm)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    rows, s = batch.shape[0], batch.shape[1] - 1
    g = rows * s
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = plain_moe_choices(torch, cfg, params, batch)
    ref = [torch.zeros_like(p) for p in leaves]
    ref_loss = ref_aux = 0.0
    for r in range(rows):
        sl = slice(r * s, (r + 1) * s)
        logits, stats = plain_moe_row(
            torch, F, cfg, params, batch[r:r + 1, :-1],
            lambda j, _: (plain["chosen"][j][sl], plain["keep"][j][sl]))
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, batch[r:r + 1, 1:, None].long())[..., 0]
        ce = (lse - picked).mean()
        del logits, lse, picked
        aux = sum(cfg.router_aux_coef * cfg.n_experts
                  * (plain["f"][j] * pr.sum(0)).sum() / g
                  + cfg.router_z_coef * z.square().sum() / g
                  for j, (pr, z) in enumerate(stats))
        loss = ce / rows + aux
        for acc, gr in zip(ref, torch.autograd.grad(loss, leaves)):
            acc.add_(gr)
        ref_loss += ce.item() / rows
        ref_aux += aux.item()
        del stats, loss, ce, aux
    ref_norm = global_norm(ref).item()
    ref_s = time.perf_counter() - t0
    model = LlamaModel(cfg, dev)

    def against_ref(run) -> dict:
        grads = run.pop("grads")
        errs = {n: ((gr.float() - rf).norm() / rf.norm()).item()
                for n, gr, rf in zip(names, grads, ref)}
        norm = global_norm(grads).item()
        del grads
        worst = max(errs, key=errs.get)
        return {"loss": run["loss"], "aux": run["aux"], "grad_norm": norm,
                "norm_rel_err": abs(norm - ref_norm) / ref_norm,
                "leaf_rel_l2": errs, "worst_leaf": worst,
                "worst_leaf_rel_l2": errs[worst]}

    free = port_moe_grads(torch, model, params, batch, chunks)
    flips = moe_flips(torch, cfg, params, free, plain)
    del free["x"], free["chosen"]
    unforced = against_ref(free)
    port = against_ref(port_moe_grads(torch, model, params, batch, chunks,
                                      forced=plain["chosen"]))
    control = against_ref(port_moe_grads(
        torch, model, params, batch, chunks, forced=plain["chosen"],
        rolled=True))
    peak = torch.cuda.max_memory_allocated()
    del params, leaves, ref, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rows": rows, "ref_loss": ref_loss, "ref_aux": ref_aux,
           "ref_grad_norm": ref_norm, "ref_s": ref_s, "peak_bytes": peak,
           "capacity": plain["capacity"],
           "plain_drop_share": plain["drop_share"],
           "plain_near_ties": plain["near_ties"], "port": port,
           "unforced": unforced, "flips": flips,
           "control_neighbour_expert": control,
           "limit_leaf_rel_l2": TRAIN_GRAD_REL_L2_LIMIT,
           "limit_norm_rel": TRAIN_NORM_REL_LIMIT,
           "tie_margin": MOE_ROUTER_TIE}
    log(f"  gradients at the plain f32 forward's routing (batch {rows} x "
        f"{s}, capacity {plain['capacity']} rows an expert, drops by layer "
        f"{[round(d, 4) for d in plain['drop_share']]}; {ref_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB): loss {port['loss']:.5f} vs "
        f"{ref_loss:.5f}, aux {port['aux']:.6f} vs {ref_aux:.6f}; grad_norm "
        f"{port['grad_norm']:.5f} vs {ref_norm:.5f} (rel "
        f"{port['norm_rel_err']:.2e}, limit {TRAIN_NORM_REL_LIMIT}); worst "
        f"leaf {port['worst_leaf']} rel L2 {port['worst_leaf_rel_l2']:.2e} "
        f"(limit {TRAIN_GRAD_REL_L2_LIMIT})")
    log("    leaf rel L2: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (each expert's output from its neighbour's rows): "
        f"worst leaf {control['worst_leaf']} rel L2 "
        f"{control['worst_leaf_rel_l2']:.3f}, grad_norm rel "
        f"{control['norm_rel_err']:.2e}")
    log(f"    unforced (the port's own routing): {flips['flips']} of "
        f"{g * cfg.n_experts_per_tok * len(flips['layers'])} (token, layer) "
        f"choices differ from the f32 router's on the port's own input, "
        f"all within {flips['flip_margin_max']:.2e} of a tie (bound "
        f"{MOE_ROUTER_TIE}; near ties in the plain forward by layer "
        f"{plain['near_ties']}); tokens routed otherwise than the "
        f"free-running plain forward by layer "
        f"{flips['differs_from_free_f32']}; grad_norm rel "
        f"{unforced['norm_rel_err']:.2e}, worst leaf "
        f"{unforced['worst_leaf']} rel L2 "
        f"{unforced['worst_leaf_rel_l2']:.2e}, loss {unforced['loss']:.5f}")
    if not (port["worst_leaf_rel_l2"] <= TRAIN_GRAD_REL_L2_LIMIT
            and port["norm_rel_err"] <= TRAIN_NORM_REL_LIMIT):
        raise RuntimeError(f"MoE training gradients off the plain "
                           f"forward's: {port}")
    if not control["worst_leaf_rel_l2"] > TRAIN_GRAD_REL_L2_LIMIT:
        raise RuntimeError(f"the neighbour-expert control passed: {control}")
    if not flips["flip_margin_max"] < MOE_ROUTER_TIE:
        raise RuntimeError(f"an expert choice differs away from a tie: "
                           f"{flips}")
    return out


class RoutingWatch:
    """Each step's router readings while the trainer runs: per routed layer
    (its forward, the first of its two calls a step under remat) the
    assignments that fit their expert's buffer (``dispatch_positions``'s
    counts) and the unscaled load-balance loss (a uniform router scores
    1), and the step's ``aux_loss``. The tensors are read once the run is
    over, so the steps sync no more than they would."""

    def __init__(self, torch, trainer, n_routed: int):
        from k8s_runpod_kubelet_tpu_torch.models import moe

        self.moe, self.n = moe, n_routed
        self.real = (moe.dispatch_positions, moe.load_balance_loss)
        self.kept, self.balance, self.aux = [], [], []
        self._step: dict = {"kept": [], "balance": []}
        watch = self

        def dispatch(*a, **kw):
            pos, counts = watch.real[0](*a, **kw)
            watch._step["kept"].append(counts.sum())
            return pos, counts

        def balance(*a, **kw):
            out = watch.real[1](*a, **kw)
            watch._step["balance"].append(out.detach())
            return out

        inner = trainer.step_fn

        def step_fn(*a, **kw):
            watch._step = {"kept": [], "balance": []}
            out = inner(*a, **kw)
            watch.kept.append(watch._step["kept"][:n_routed])
            watch.balance.append(watch._step["balance"][:n_routed])
            watch.aux.append(out["aux_loss"])
            return out

        trainer.step_fn = step_fn
        moe.dispatch_positions, moe.load_balance_loss = dispatch, balance

    def close(self, assignments: int) -> dict:
        """Restore the module; the readings as floats: per step and routed
        layer the share of the ``assignments`` (B x S x k) dropped and the
        load-balance loss, and each step's aux_loss."""
        self.moe.dispatch_positions, self.moe.load_balance_loss = self.real
        return {"drop_share": [[1.0 - float(c) / assignments for c in step]
                               for step in self.kept],
                "load_balance": [[float(b) for b in step]
                                 for step in self.balance],
                "aux_loss": [float(a) for a in self.aux]}


def moe_finetune_phase(torch, dev, card: str) -> dict:
    """Phase 9e (c): ``train_main.main --model deepseek-v2-lite`` (all 27
    layers, random init from its seed, the frozen base drawn straight into
    bf16) ``--lora-rank 16 --lora-targets wq,wo --fused-ce-chunks 8
    --batch 4 --seq-len 2048`` for MOE_FT_STEPS steps from a token file
    (phase 9f's seeded pattern), checkpoints every MOE_FT_EVERY steps,
    a telemetry line every step: the summary line, the loss falling, the
    aux finite each step, every frozen leaf (the dense prefix, the experts
    and the router among them) bit-identical after the run, Adam moments
    only on the adapters, the peak within the card (the init's too),
    launches exact each step, one heartbeat a step; then a second
    ``train_main`` resumes at step MOE_FT_STEPS with every leaf
    bit-identical to the first run's last."""
    import contextlib
    import io

    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import train as train_mod
    from k8s_runpod_kubelet_tpu_torch.workloads import train_main
    from k8s_runpod_kubelet_tpu_torch.workloads.telemetry import (
        parse_heartbeat, parse_telemetry)

    cfg = MODEL_CONFIGS[MOE_FT_MODEL]()
    n = cfg.n_layers
    # the adapters sit in the main stack: the dense prefix takes a frozen
    # input and holds no adapter, so autograd runs no backward there, and
    # its remat recompute, dQ and dK/dV never launch
    m = n - cfg.n_dense_prefix
    layer_norms = 2 + (cfg.is_mla + (cfg.mla_q_lora_rank is not None))
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": n + m, "flash_dq": m, "flash_dkv": m,
                "rms_norm": layer_norms * (n + m) + 1}
    made: list = []

    class Routed(watched_trainer(torch, train_mod.Trainer, kernels, made)):
        """The watched trainer with its routing read (``RoutingWatch``)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.routing = RoutingWatch(torch, self, m)

    def routing_of(tr) -> dict:
        return tr.routing.close(FT_BATCH * FT_SEQ * cfg.n_experts_per_tok)
    cap = _Capture()
    watched_logs = [logging.getLogger("train-main"),
                    logging.getLogger("k8s_runpod_kubelet_tpu_torch.workloads")]
    for lg in watched_logs:
        lg.addHandler(cap)
        lg.setLevel(logging.INFO)
    train_mod.Trainer, real_trainer = Routed, train_mod.Trainer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(SEED)
            pattern = rng.integers(0, cfg.vocab_size, FT_PATTERN)
            data = os.path.join(tmp, "tokens.bin")
            np.resize(pattern, FT_WINDOWS * FT_SEQ + 1).astype("<i4") \
                .tofile(data)
            ck = os.path.join(tmp, "ck")
            argv = ["--model", cfg.name, "--lora-rank", str(FT_RANK),
                    "--lora-targets", MOE_FT_TARGETS, "--fused-ce-chunks",
                    str(FT_CHUNKS), "--batch", str(FT_BATCH), "--seq-len",
                    str(FT_SEQ), "--lr", str(FT_LR), "--data", data,
                    "--checkpoint-dir", ck, "--checkpoint-every",
                    str(MOE_FT_EVERY), "--telemetry-every", "1"]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            stdout, tee = io.StringIO(), _Tee(sys.stderr)
            # the main path: counts set to 0 just before the run, read
            # just after
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout), \
                    contextlib.redirect_stderr(tee):
                rc = train_main.main(argv + ["--steps", str(MOE_FT_STEPS)])
            main_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            peak = torch.cuda.max_memory_allocated()
            if rc != 0 or len(made) != 1:
                raise RuntimeError(f"(c) train_main exited {rc}, "
                                   f"{len(made)} trainers")
            summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
            tr = made[0]
            routing = routing_of(tr)
            after = leaf_checksums(torch, tr.params, True)
            moments = list(leaf_checksums(torch, tr.opt_state["mu"], False))
            beats = [parse_heartbeat(ln) for ln in tee.lines
                     if ln.startswith("TPU_STEP_HEARTBEAT")]
            last = parse_telemetry("\n".join(tee.lines))
            frozen_bytes = sum(t.numel() * t.element_size()
                               for t in train_mod._leaves(tr.params)
                               if not t.requires_grad)
            step_s = statistics.median(tr.walls[1:])
            out = {"model": cfg.name, "layers": n, "summary": summary,
                   "losses": tr.losses, "aux_losses": tr.auxes,
                   "step_walls_s": tr.walls, "step_s_median": step_s,
                   "tokens_per_s": FT_BATCH * FT_SEQ / step_s,
                   "peak_bytes": peak, "init_peak_bytes": tr.init_peak,
                   "frozen_bytes": frozen_bytes,
                   "frozen_leaves": len(after), "launches": launches,
                   "launches_per_step": per_step, "main_s": main_s,
                   "heartbeats": beats, "last_telemetry": last,
                   "routing": routing}
            log(f"  (c) [{card}] {cfg.name} ({n} layers) LoRA r={FT_RANK} on "
                f"{MOE_FT_TARGETS} through train_main: losses "
                f"{[round(x, 4) for x in tr.losses]}, aux "
                f"{[round(x, 6) for x in tr.auxes]}; step walls "
                f"{[round(w, 4) for w in tr.walls]} s, median of steps 2-"
                f"{MOE_FT_STEPS} {step_s:.4f} s, "
                f"{out['tokens_per_s']:.0f} tokens/s; frozen leaves "
                f"{frozen_bytes / 2**30:.2f} GiB ({len(after)} of them); "
                f"peak {peak / 2**30:.2f} GiB allocated over the steps and "
                f"saves ({tr.init_peak / 2**30:.2f} GiB in the init); "
                f"launches {launches} ({per_step} a step); {len(beats)} "
                f"heartbeats; train_main {main_s:.1f} s; summary {summary}")
            log(f"  (c) dropped share by step, the mean over the {m} routed "
                f"layers: {[round(sum(d) / m, 4) for d in routing['drop_share']]}"
                f"; load-balance loss, their mean: "
                f"{[round(sum(b) / m, 4) for b in routing['load_balance']]}")
            if not (summary["workload"] == "pretrain"
                    and summary["model"] == cfg.name
                    and summary["steps"] == MOE_FT_STEPS
                    and math.isfinite(summary["final_loss"])):
                raise RuntimeError(f"(c) the summary line {summary}")
            if not tr.losses[-1] < tr.losses[0]:
                raise RuntimeError(f"(c) the loss did not fall: {tr.losses}")
            if not all(math.isfinite(a) and a > 0 for a in tr.auxes):
                raise RuntimeError(f"(c) aux_loss {tr.auxes}")
            if after != tr.init_sums:
                raise RuntimeError("(c) frozen leaves changed: "
                                   f"{[k for k in after if after[k] != tr.init_sums.get(k)]}")
            for want in ("prefix_layers/w_down", "layers/we_gate",
                         "layers/we_down", "layers/router",
                         "layers/wq/w", "layers/ws_up"):
                if want not in after:
                    raise RuntimeError(f"(c) {want} is not frozen: "
                                       f"{sorted(after)}")
            if not moments or not all(m.endswith(("/lora_a", "/lora_b"))
                                      for m in moments):
                raise RuntimeError(f"(c) Adam moments on {moments}")
            if not max(peak, tr.init_peak) <= CARD_BYTES:
                raise RuntimeError(f"(c) peak {peak} bytes (init "
                                   f"{tr.init_peak}) does not fit the card")
            for i, got in enumerate(tr.launches):
                if got != per_step:
                    raise RuntimeError(f"(c) step {i + 1} launched {got}, "
                                       f"not {per_step}")
            if launches != {k: v * MOE_FT_STEPS for k, v in per_step.items()}:
                raise RuntimeError(f"(c) launches over the run {launches}")
            if [b[1] for b in beats] != list(range(1, MOE_FT_STEPS + 1)) \
                    or last is None or last["step"] != MOE_FT_STEPS:
                raise RuntimeError(f"(c) heartbeats {beats}, last telemetry "
                                   f"{last}")
            final_sums = leaf_checksums(torch, tr.params, False)
            del tr
            made.clear()
            gc.collect()
            torch.cuda.empty_cache()
            # a second life resumes at step MOE_FT_STEPS
            cap.lines.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(_Tee(sys.stderr)):
                rc = train_main.main(argv + ["--steps", "1"])
            resume_s = time.perf_counter() - t0
            tr2 = made[0]
            routing_of(tr2)
            marker = f"resumed from checkpoint step {MOE_FT_STEPS}"
            if rc != 0 or marker not in cap.lines:
                raise RuntimeError(f"(c) the second life: rc {rc}, logged "
                                   f"{cap.lines}")
            if tr2.restored_sums != final_sums:
                bad = [k for k in final_sums
                       if tr2.restored_sums.get(k) != final_sums[k]]
                raise RuntimeError(f"(c) restored leaves differ: {bad}")
            out.update(resumed=True, restored_leaves=len(final_sums),
                       resume_s=resume_s, resume_loss=tr2.losses[-1])
            log(f"  (c) [{card}] a second train_main logged {marker!r}; all "
                f"{len(final_sums)} leaves bit-identical to the first run's "
                f"last; its step's loss {tr2.losses[-1]:.4f} "
                f"({resume_s:.1f} s)")
            del tr2
    finally:
        train_mod.Trainer = real_trainer
        for tr in made:
            routing_of(tr)
        for lg in watched_logs:
            lg.removeHandler(cap)
        made.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_train_phase(torch, dev, card: str) -> dict:
    """Phase 9e: (a) mixtral-8x7b and (b) deepseek-v2-lite (fused loss)
    through ``train_phase`` at ``train_layers`` depth, (c) the LoRA
    fine-tune of deepseek-v2-lite at full depth (module docstring)."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        train_layers

    out = {}
    for name, key, chunks in (("mixtral-8x7b", "mixtral", 0),
                              ("deepseek-v2-lite", "deepseek", FT_CHUNKS)):
        cfg = dataclasses.replace(MODEL_CONFIGS[name](),
                                  n_layers=train_layers(name))
        log(f"  9e ({'ab'[len(out)]}): {name} widths, {cfg.n_layers} layers, "
            f"batch 8 x 2048, fused_ce_chunks {chunks}")
        out[key] = train_phase(torch, dev, card, cfg, chunks=chunks)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  9e (c): {MOE_FT_MODEL} LoRA r={FT_RANK} on {MOE_FT_TARGETS} at "
        f"full depth through train_main")
    out["finetune"] = moe_finetune_phase(torch, dev, card)
    return out


# -- phases 4-7: the engine ------------------------------------------------------------

def http_generate(port: int, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def prefix_path_check(torch, model, params, prompt: list[int]) -> dict:
    """Last-token logits of one prompt prefilled in one chunk (A), through
    a cached prefix of its full pages plus the tail chunk (B), as a prefix
    hit computes them, and in two uncached chunks split where B's cache
    ends (C). B and C run the same tail chunk over the same prefix K/V;
    they differ only in whether the prefix pages were written by A's
    one-chunk prefill or by C's first chunk. So |B - C| is what the cache
    adds, and |A - C| what the tail chunk's GEMM shapes alone change.
    Reported against the logits' spread and A's top-1 margin."""
    dev, t, n = model.device, 16, len(prompt)
    n_pages = -(-n // t)
    cached = (n - 1) // t                     # the trie's match cap
    arena = model.init_paged_arena(3 * n_pages, t)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    table_a = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    table_a[0, :n_pages] = torch.arange(n_pages, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    la, _, _ = model.paged_prefill_chunk_step(
        params, toks, arena, table_a, zero,
        torch.tensor([n], dtype=torch.int32, device=dev))
    table_b = table_a.clone()
    table_b[0, cached:n_pages] = torch.arange(
        n_pages, 2 * n_pages - cached, device=dev)
    lb, _, _ = model.paged_prefill_chunk_step(
        params, toks[:, cached * t:], arena, table_b,
        zero + cached * t,
        torch.tensor([n - cached * t], dtype=torch.int32, device=dev))
    half = cached * t
    table_c = table_a.clone()
    table_c[0, :n_pages] = torch.arange(n_pages, 2 * n_pages, device=dev)
    _, _, done = model.paged_prefill_chunk_step(
        params, toks[:, :half], arena, table_c, zero,
        torch.tensor([half], dtype=torch.int32, device=dev))
    lc, _, _ = model.paged_prefill_chunk_step(
        params, toks[:, half:], arena, table_c, done,
        torch.tensor([n - half], dtype=torch.int32, device=dev))
    a, b, c = la[0], lb[0], lc[0]
    top2 = a.topk(2).values
    return a, {"prompt_tokens": n, "cached_tokens": cached * t,
            "max_abs_diff": (a - b).abs().max().item(),
            "cache_vs_uncached_max_abs_diff": (b - c).abs().max().item(),
            "two_chunk_max_abs_diff": (a - c).abs().max().item(),
            "logit_std": a.std().item(),
            "top1_margin": (top2[0] - top2[1]).item(),
            "argmax_agree": bool(a.argmax() == b.argmax())}


def layer_f32(w, layer=None):
    """A weight leaf (of one layer) in f32: a raw weight upcast, a
    quantized leaf dequantized, a LoRA leaf merged (``merge_lora``'s
    fold, base + A @ B * scale, all in f32 and one layer at a time)."""
    from k8s_runpod_kubelet_tpu_torch.models.quant import dequantize

    if isinstance(w, dict) and "lora_a" in w:
        def pick(v):
            return v if layer is None else v[layer]
        return layer_f32(w["w"], layer) + (
            pick(w["lora_a"]).float() @ pick(w["lora_b"]).float()
        ) * pick(w["scale"]).float()
    if isinstance(w, dict):
        return dequantize({k: (v if layer is None else v[layer])
                           for k, v in w.items()})
    return (w if layer is None else w[layer]).float()


def plain_mlp(torch, F, cfg, lp, h, margins=None, chosen=None, picks=None):
    """The MLP of one layer in f32 from its f32 weights: SwiGLU, or for a
    layer with a router each token's top-k experts by its f32 router
    (softmax, top k, renormalized with ``router_norm_topk``, else the raw
    probabilities: DeepSeek-V2-Lite), each expert run on the tokens that
    chose it, with no capacity buffer, plus DeepSeek's shared experts (a
    SwiGLU of the ``ws_*`` weights). ``margins`` (a list) gets the layer's
    count of tokens whose k-th and (k+1)-th router probabilities lie
    within 1e-3, where bf16 noise in the engine's hidden state may pick
    another expert. ``chosen`` (..., k) forces the experts (their weights
    the f32 probabilities there); ``picks`` (a list) gets the layer's
    choices."""
    if "router" not in lp:
        return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    probs = torch.softmax(h @ lp["router"], dim=-1)
    top = torch.topk(probs, cfg.n_experts_per_tok + 1, dim=-1)
    if margins is not None:
        k = cfg.n_experts_per_tok
        margins.append(int((top.values[..., k - 1] - top.values[..., k]
                            < 1e-3).sum()))
    if chosen is None:
        chosen = top.indices[..., :-1]
    if picks is not None:
        picks.append(chosen)
    weight = torch.gather(probs, -1, chosen)
    if cfg.router_norm_topk:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    if "ws_gate" in lp:
        y += (F.silu(h @ lp["ws_gate"]) * (h @ lp["ws_up"])) @ lp["ws_down"]
    for x in range(cfg.n_experts):
        pick = chosen == x                                  # (..., k)
        rows = pick.any(dim=-1)
        if not rows.any():
            continue
        hx = h[rows]
        yx = (F.silu(hx @ lp["we_gate"][x]) * (hx @ lp["we_up"][x])) \
            @ lp["we_down"][x]
        y[rows] += (weight * pick).sum(dim=-1)[rows][:, None] * yx
    return y


def plain_attention(torch, cfg, lp, x, cos, sin):
    """The attention block of one layer in f32 from its f32 weights, on
    the residual stream x (B, S, E): its output, before the residual add
    (causal ``_attention_plain``; an MLA model in the direct form)."""
    from k8s_runpod_kubelet_tpu_torch.ops.attention import _attention_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import apply_rope

    (b, n, _), hd = x.shape, cfg.head_dim_
    h = _rms_norm_plain(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.is_mla:
        q, k, v = mla_direct_qkv(torch, cfg, lp, h, cos, sin)
    else:
        q = apply_rope((h @ lp["wq"]).view(b, n, cfg.n_heads, hd), cos, sin)
        k = apply_rope((h @ lp["wk"]).view(b, n, cfg.n_kv_heads, hd), cos,
                       sin)
        v = (h @ lp["wv"]).view(b, n, cfg.n_kv_heads, hd)
    o = _attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True,
                         sm_scale=cfg.sm_scale)[..., :hd]
    return o.transpose(1, 2).reshape(b, n, -1) @ lp["wo"]


def plain_logits(torch, cfg, params, tokens, skip_layer=None,
                 last_only=False, hidden=False, margins=None, picks=None,
                 mlp=None):
    """Logits (B, S, V) of tokens (B, S), or with ``last_only`` the last
    position's (B, V), from a plain f32 forward of the same weights: no
    paging, no KV quantization and no kernels (``_attention_plain``,
    ``_rms_norm_plain``), each layer's weights upcast (or dequantized) only
    while it runs (an upcast is a no-op on f32 master weights, through
    which autograd then reaches the parameters); an MLA model's attention in
    the direct form (``mla_direct_qkv``). ``skip_layer`` leaves one layer
    out (a control); ``hidden`` returns the final-norm hidden states
    instead of logits; ``margins`` and ``picks`` collect ``plain_mlp``'s
    near ties and choices of an MoE router, one entry a layer; ``mlp``
    (layer, its f32 leaves, normed h) -> MLP output replaces ``plain_mlp``
    in the layers with a router (phase 9e's capacity routing)."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import rope_frequencies

    dev = params["tok_embed"].device
    hd = cfg.head_dim_
    cos, sin = rope_frequencies(cfg.mla_rope_dim if cfg.is_mla else hd,
                                cfg.max_seq_len, cfg.rope_theta,
                                cfg.rope_scaling, device=dev)
    x = params["tok_embed"][tokens.long()].float()
    for layer, (stack, j) in enumerate(layer_stacks(cfg, params)):
        if layer == skip_layer:
            continue
        lp = {k: layer_f32(w, j) for k, w in stack.items()}
        x = x + plain_attention(torch, cfg, lp, x, cos, sin)
        h = _rms_norm_plain(x, lp["mlp_norm"], cfg.norm_eps)
        if mlp is not None and "router" in lp:
            x = x + mlp(layer, lp, h)
        else:
            x = x + plain_mlp(torch, F, cfg, lp, h, margins, picks=picks)
        del lp
    if last_only:
        x = x[:, -1]
    x = _rms_norm_plain(x, params["final_norm"], cfg.norm_eps)
    if hidden:
        return x
    if cfg.tie_embeddings:
        return x @ params["tok_embed"].t().float()
    return x @ layer_f32(params["lm_head"])


def layer_stacks(cfg, params) -> list:
    """(stacked leaves, index in them) of every layer in the order the
    model runs them: DeepSeek's dense prefix (``prefix_layers``) first."""
    k = cfg.n_dense_prefix
    return ([(params["prefix_layers"], j) for j in range(k)]
            + [(params["layers"], j) for j in range(cfg.n_layers - k)])


def mla_direct_qkv(torch, cfg, lp, h, cos, sin):
    """The direct (non-absorbed) form of MLA attention, as the JAX
    package's ``_mla_attention_block`` computes it, in f32 from one layer's
    f32 weights: per-head K = [c w_uk, kr] and V = c w_uv zero-padded to
    head_dim + rope_dim, so one plain attention at that width computes
    q_nope . k_nope + q_rope . kr and the weighted V (its padded tail is
    sliced off after). No paging, no absorption, no kernels."""
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import apply_rope

    b, n, _ = h.shape
    hn, hd, dr, r = (cfg.n_heads, cfg.head_dim_, cfg.mla_rope_dim,
                     cfg.mla_latent_dim)
    if cfg.mla_q_lora_rank is not None:
        q = _rms_norm_plain(h @ lp["w_qa"], lp["q_a_norm"], cfg.norm_eps) \
            @ lp["w_qb"]
    else:
        q = h @ lp["wq"]
    q = q.view(b, n, hn, hd + dr)
    ckr = h @ lp["w_dkv"]
    c = _rms_norm_plain(ckr[..., :r], lp["c_norm"], cfg.norm_eps)
    kr = apply_rope(ckr[..., None, r:], cos, sin)              # (B,S,1,dr)
    q = torch.cat([q[..., :hd], apply_rope(q[..., hd:], cos, sin)], -1)
    k = torch.cat([(c @ lp["w_uk"]).view(b, n, hn, hd),
                   kr.expand(b, n, hn, dr)], -1)
    v = torch.cat([(c @ lp["w_uv"]).view(b, n, hn, hd),
                   torch.zeros((b, n, hn, dr), device=h.device)], -1)
    return q, k, v


def reference_logits(torch, cfg, params, prompt: list[int],
                     skip_layer=None, margins=None, picks=None):
    """Last-token logits (V,) of ``prompt`` from ``plain_logits``."""
    toks = torch.tensor(prompt, device=params["tok_embed"].device)[None]
    return plain_logits(torch, cfg, params, toks, skip_layer,
                        last_only=True, margins=margins, picks=picks)[0]


def engine_reference_check(torch, cfg, params, prompt, engine_logits,
                           limit=ENGINE_REL_L2_LIMIT, what="engine",
                           gate=True, picks=None, keep=None):
    """The engine path's logits against the plain f32 forward of the same
    (dequantized) weights, within ``limit``; the forward with its middle
    layer skipped must land outside it (with ``gate=False`` both are
    reported, not required). For an MoE model it also counts the (token,
    layer) pairs of the forward whose router's 2nd and 3rd probabilities
    lie within 1e-3 (the k-th and (k+1)-th under top-k); ``picks`` (a
    list) gets the forward's choices of experts, one (1, S, k) tensor a
    routed layer; ``keep`` (a list) the forward's logits."""
    margins: list = []
    ref = reference_logits(torch, cfg, params, prompt, margins=margins,
                           picks=picks)
    if keep is not None:
        keep.append(ref)
    ctrl = reference_logits(torch, cfg, params, prompt,
                            skip_layer=cfg.n_layers // 2)

    def rel_l2(a):
        return ((a - ref).norm() / ref.norm()).item()

    out = {"prompt_tokens": len(prompt), "rel_l2": rel_l2(engine_logits),
           "max_abs_diff": (engine_logits - ref).abs().max().item(),
           "ref_logit_std": ref.std().item(),
           "argmax_agree": bool(engine_logits.argmax() == ref.argmax()),
           "control_skip_layer_rel_l2": rel_l2(ctrl),
           "limit_rel_l2": limit}
    if cfg.n_experts:
        out["router_near_ties"] = {"pairs": sum(margins),
                                   "of": len(prompt) * cfg.n_layers,
                                   "by_layer": margins}
        k = cfg.n_experts_per_tok
        routed = cfg.n_layers - cfg.n_dense_prefix
        out["router_near_ties"]["of"] = len(prompt) * routed
        log(f"  router near ties in the f32 forward ({k}th - {k + 1}th "
            f"probability < 1e-3): {sum(margins)} of {len(prompt) * routed} "
            f"(token, layer) pairs; by routed layer {margins}")
    log(f"  independent check: {what} vs plain f32 forward, last-token "
        f"logits of a {len(prompt)}-token prompt: relative L2 "
        f"{out['rel_l2']:.4f} (limit {limit}), max abs "
        f"{out['max_abs_diff']:.4f} (logit std {out['ref_logit_std']:.4f}), "
        f"argmax agree {out['argmax_agree']}; control (layer "
        f"{cfg.n_layers // 2} skipped) {out['control_skip_layer_rel_l2']:.4f}")
    if gate and not out["rel_l2"] <= limit:
        raise RuntimeError(f"{what} logits off the plain forward: {out}")
    if gate and not out["control_skip_layer_rel_l2"] > limit:
        raise RuntimeError(f"the skipped-layer control passed: {out}")
    return out


def moe_layer_check(torch, model, params, prompt, free_picks,
                    kv_int8=False, ref_params=None, gate=True) -> dict:
    """The MoE engine path held one layer at a time: the last-token
    check's one-chunk prefill of ``prompt`` runs again (over an int8 arena
    with ``kv_int8``) with each layer's MLP input and output recorded (the
    engine's bf16 residual stream), and each layer's attention and MLP
    outputs are held against the plain f32 layer (``plain_attention``,
    ``plain_mlp``) on that same input, by the relative L2 norm of the
    output. A routed layer's MLP reference takes the experts the engine
    chose (its router on its own input, ``route_top_k``), each weighted by
    the f32 probabilities there (renormalized or raw, as the config
    routes), plus the shared experts of a DeepSeek layer; every token
    whose choice differs from the f32 router's on the same input must be a
    near tie (k-th and (k+1)-th probabilities within ``MOE_ROUTER_TIE``),
    and the pairs within that margin are counted. A dense layer (DeepSeek's
    prefix) is held as a dense MLP. Controls, which must read above the
    limit in every layer: a routed MLP with each expert given its
    neighbour's weights, a dense MLP with its down projection's rows
    rolled; the attention reference with the next layer's weights.
    Reported beside: in each routed layer, the tokens whose engine choice
    differs from the choice of the free-running f32 forward
    (``free_picks``, one (1, S, k) tensor a routed layer), which sees its
    own, diverging, hidden states. ``ref_params`` (default ``params``) are
    the references' weights, unsharded, where ``model`` runs a tree laid
    out over a mesh; with ``gate=False`` nothing is required (a
    control's reading)."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.models.moe import route_top_k
    from k8s_runpod_kubelet_tpu_torch.ops import rms_norm
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import rope_frequencies

    cfg = model.cfg
    seen = []
    paged_mlp = model._paged_mlp

    def record(x, lp, layer, *adapter):
        out = paged_mlp(x, lp, layer, *adapter)
        seen.append((x.clone(), out.clone()))
        return out

    model._paged_mlp = record
    try:
        quant_logits(torch, model, params, prompt, kv_int8=kv_int8)
    finally:
        del model._paged_mlp
    if len(seen) != cfg.n_layers:
        raise RuntimeError(f"recorded {len(seen)} MLP calls")
    params = params if ref_params is None else ref_params
    dev = params["tok_embed"].device
    cos, sin = rope_frequencies(
        cfg.mla_rope_dim if cfg.is_mla else cfg.head_dim_, cfg.max_seq_len,
        cfg.rope_theta, cfg.rope_scaling, device=dev)
    toks = torch.tensor([prompt], device=dev)
    stacks = layer_stacks(cfg, params)
    k = cfg.n_experts_per_tok
    mlp_names = set(model._MLP_LEAVES)

    def rel(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    rows = []
    routed = 0
    x_in = params["tok_embed"][toks.long()].float()
    for layer, (stack, j) in enumerate(stacks):
        lp = {n: layer_f32(w, j) for n, w in stack.items()}
        mid, out = (t.float() for t in seen[layer])
        attn = plain_attention(torch, cfg, lp, x_in, cos, sin)
        nstack, nj = stacks[(layer + 1) % cfg.n_layers]
        attn_ctrl = plain_attention(
            torch, cfg, {n: layer_f32(w, nj) for n, w in nstack.items()
                         if n not in mlp_names}, x_in, cos, sin)
        h = _rms_norm_plain(mid, lp["mlp_norm"], cfg.norm_eps)
        row = {"layer": layer, "attn_rel_l2": rel(mid - x_in, attn),
               "attn_control_rel_l2": rel(mid - x_in, attn_ctrl)}
        if "router" not in lp:
            mlp = plain_mlp(torch, F, cfg, lp, h)
            mlp_ctrl = plain_mlp(torch, F, cfg, dict(
                lp, w_down=torch.roll(lp["w_down"], 1, dims=0)), h)
            row.update(dense=True, mlp_rel_l2=rel(out - mid, mlp),
                       mlp_control_rel_l2=rel(out - mid, mlp_ctrl),
                       choices_differing=0, near_ties=0,
                       differing_margin_max=0.0)
            rows.append(row)
            x_in = out
            del lp
            continue
        # the engine's choices: its router on its own (bf16-normed) input
        h_eng = rms_norm(seen[layer][0], stack["mlp_norm"][j], cfg.norm_eps)
        _, chosen, _ = route_top_k(
            h_eng.float() @ stack["router"][j].float(), k,
            cfg.router_norm_topk)
        chosen = chosen.view(h.shape[:-1] + (k,))
        mlp = plain_mlp(torch, F, cfg, lp, h, chosen=chosen)
        rolled = dict(lp, **{n: torch.roll(lp[n], 1, dims=0)
                             for n in ("we_gate", "we_up", "we_down")})
        mlp_ctrl = plain_mlp(torch, F, cfg, rolled, h, chosen=chosen)
        probs = torch.softmax(h @ lp["router"], dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        differs = (torch.sort(top.indices[..., :k], -1).values
                   != torch.sort(chosen, -1).values).any(-1)
        margin = top.values[..., k - 1] - top.values[..., k]
        spread = (torch.sort(free_picks[routed], -1).values
                  != torch.sort(chosen, -1).values).any(-1)
        routed += 1
        row.update({
            "dense": False, "mlp_rel_l2": rel(out - mid, mlp),
            "mlp_control_rel_l2": rel(out - mid, mlp_ctrl),
            "choices_differing": int(differs.sum()),
            "near_ties": int((margin < MOE_ROUTER_TIE).sum()),
            "differs_from_free_f32": int(spread.sum()),
            "last_token_differs_from_free_f32": bool(spread[0, -1]),
            "differing_margin_max": (margin[differs].max().item()
                                     if differs.any() else 0.0)})
        rows.append(row)
        x_in = out
        del lp, rolled
    worst = {key: max(r[key] for r in rows)
             for key in ("attn_rel_l2", "mlp_rel_l2", "differing_margin_max")}
    ctrl = {key: min(r[key] for r in rows)
            for key in ("attn_control_rel_l2", "mlp_control_rel_l2")}
    differing = sum(r["choices_differing"] for r in rows)
    ties = sum(r["near_ties"] for r in rows)
    spread = [r["differs_from_free_f32"] for r in rows if not r["dense"]]
    res = {"limit_rel_l2": MOE_LAYER_REL_L2_LIMIT,
           "tie_margin": MOE_ROUTER_TIE, "worst": worst,
           "controls_least": ctrl, "choices_differing": differing,
           "near_tie_pairs": ties, "of": len(prompt) * routed,
           "kv_int8": kv_int8, "layers": rows}
    log(f"  layer check: each of {cfg.n_layers} layers ({routed} routed) "
        f"against the plain f32 layer on the engine's own input "
        f"({len(prompt)} tokens): worst attention {worst['attn_rel_l2']:.4f}"
        f", worst MLP (the engine's experts) {worst['mlp_rel_l2']:.4f} "
        f"relative L2 (limit {MOE_LAYER_REL_L2_LIMIT}); controls at least: "
        f"next layer's attention {ctrl['attn_control_rel_l2']:.3f}, "
        f"neighbour expert (dense: rolled down rows) "
        f"{ctrl['mlp_control_rel_l2']:.3f}; {differing} of {res['of']} "
        f"(token, layer) choices differ from the f32 router's, all within "
        f"{worst['differing_margin_max']:.2e} of a tie (bound "
        f"{MOE_ROUTER_TIE}); {ties} (token, layer) pairs have their "
        f"{k}th and {k + 1}th probabilities within {MOE_ROUTER_TIE}")
    last = [r["layer"] for r in rows
            if r.get("last_token_differs_from_free_f32")]
    log(f"  tokens whose engine choice differs from the free-running f32 "
        f"forward's, by routed layer: {spread}; the last token's in layers "
        f"{last}")
    if not gate:
        return res
    if not (worst["attn_rel_l2"] <= MOE_LAYER_REL_L2_LIMIT
            and worst["mlp_rel_l2"] <= MOE_LAYER_REL_L2_LIMIT):
        raise RuntimeError(f"a layer is off the plain f32 layer: {res}")
    if not min(ctrl.values()) > MOE_LAYER_REL_L2_LIMIT:
        raise RuntimeError(f"a layer check control passed: {res}")
    if not worst["differing_margin_max"] < MOE_ROUTER_TIE:
        raise RuntimeError(f"a routing choice differs away from a tie: {res}")
    return res


def burst_prompts(cfg) -> tuple[list, list, "np.random.Generator"]:
    """The seeded traffic both engines serve: a warm-up prompt no measured
    request shares, 8 prompts of 200-900 tokens (two sharing a 96-token
    prefix), and the generator for the later prompts."""
    import numpy as np

    rng = np.random.default_rng(SEED)

    def prompt(n: int) -> list[int]:
        return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

    warm = prompt(64)
    prompts = [prompt(int(n)) for n in rng.integers(200, 901, 8)]
    prompts[1] = prompts[0][:96] + prompts[1][96:]
    return warm, prompts, prompt


def last_seq(engine) -> int:
    """The sequence number of the flight recorder's newest record."""
    recs = engine.recorder.records(1) if engine.recorder is not None else []
    return recs[0]["seq"] if recs else -1


def recorder_stats(engine, after: int, what: str, card: str) -> dict:
    """(f) The flight recorder's step records newer than ``after``, by
    mode: the step wall's and each phase's median in ms. The ring must
    hold at most ``recorder_bytes``."""
    rec = engine.recorder
    if rec.ring_bytes > rec.max_bytes:
        raise RuntimeError(f"{what}: flight-recorder ring {rec.ring_bytes} B "
                           f"over its bound {rec.max_bytes}")
    steps = [r for r in rec.records() if "wall_s" in r and r["seq"] > after]
    out = {"ring_bytes": rec.ring_bytes, "max_bytes": rec.max_bytes}
    for mode in sorted({r["batch"]["mode"] for r in steps}):
        rs = [r for r in steps if r["batch"]["mode"] == mode]
        m = {"steps": len(rs), "wall_ms": statistics.median(
            r["wall_s"] for r in rs) * 1e3}
        for ph in ("schedule", "kernel", "sample", "commit"):
            m[f"{ph}_ms"] = statistics.median(
                r["phases"][f"{ph}_s"] for r in rs) * 1e3
        out[mode] = m
        log(f"  (f) [{card}] {what}, {mode} steps ({len(rs)}), medians: wall "
            f"{m['wall_ms']:.3f} ms = schedule {m['schedule_ms']:.3f} + "
            f"kernel {m['kernel_ms']:.3f} + sample {m['sample_ms']:.3f} + "
            f"commit {m['commit_ms']:.3f} ms; ring {rec.ring_bytes} B of "
            f"{rec.max_bytes}")
    return out


def serve_burst(torch, engine, cfg, card: str, kernels, per_step,
                adapters=None) -> dict:
    """The engine's main path, read per path: the 8-request burst (counts
    set to 0 just before it, read just after), its decode-only stretch
    after the last prefill, a prefill-only stretch (a 1500-token prompt in
    two chunks, one new token), and a repeat. ``per_step`` maps each
    kernel to its launches per decode step or prefill chunk (0: must not
    launch). ``adapters`` names each burst request's LoRA adapter ("" the
    base); the two prompts sharing the 96-token prefix must then hit only
    if they share an adapter."""
    warm, prompts, prompt = burst_prompts(cfg)
    names = list(adapters) if adapters else [""] * len(prompts)
    # warm-up: cuBLAS handles and first-call allocations stay out of the
    # measured phase
    engine.submit(warm, max_new_tokens=4).result(timeout=900)
    hits0 = engine.counters["prefix_cache_hits"]

    def snap() -> dict:
        # steps and chunks count under the arena lock with their launches,
        # so a snapshot taken holding it is consistent
        with engine._prefix_lock:
            return {"paged_prefill_chunks":
                    engine.counters["paged_prefill_chunks"],
                    "decode_steps": engine.counters["decode_steps"],
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    def stretch(a: dict, b: dict, path: str) -> dict:
        d = {k: b[k] - a[k] for k in a}
        steps = d["paged_prefill_chunks"] + d["decode_steps"]
        if d["replays"] != d["decode_steps"]:
            raise RuntimeError(f"{path}: {d['replays']} graph replays for "
                               f"{d['decode_steps']} decode steps")
        for name, n in per_step.items():
            if d[name] != n * steps or (n and d[name] < 1):
                raise RuntimeError(
                    f"{path}: {name} launched {d[name]} times in "
                    f"{d['paged_prefill_chunks']} prefill chunks and "
                    f"{d['decode_steps']} decode steps, not {n} per step")
        return d

    with engine._prefix_lock:
        for k in kernels:
            k.launches = 0
    s0 = snap()
    seq0 = last_seq(engine)
    t_start = time.perf_counter()
    futs = [engine.submit(p, adapter=a) for p, a in zip(prompts, names)]
    deadline = time.monotonic() + 900
    while (engine.counters["paged_prefill_chunks"]
           - s0["paged_prefill_chunks"]) < 8:
        if time.monotonic() > deadline:
            raise RuntimeError("the burst's 8 prefills did not finish")
        time.sleep(0.001)
    s1 = snap()
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t_start
    s2 = snap()
    launches = {k.__name__: k.launches for k in kernels}
    recorder = (recorder_stats(engine, seq0, "burst", card)
                if engine.recorder is not None else None)

    if len(results) != 8 or any(len(r["tokens"]) != 32 for r in results):
        raise RuntimeError("not all 8 requests finished with 32 tokens")
    hits = engine.counters["prefix_cache_hits"] - hits0
    if names[0] == names[1] and hits < 1:
        raise RuntimeError("the shared 96-token prefix did not hit")
    if names[0] != names[1] and hits:
        raise RuntimeError(f"{hits} prefix hits across adapters "
                           f"{names[0]!r} and {names[1]!r}")
    burst = stretch(s0, s2, "burst")
    decode = stretch(s1, s2, "decode-only stretch")
    if decode["paged_prefill_chunks"] or burst["paged_prefill_chunks"] != 8:
        raise RuntimeError(f"burst counted {burst['paged_prefill_chunks']} "
                           f"prefill chunks, {decode['paged_prefill_chunks']} "
                           f"of them after the eighth")
    ttft = [r["ttft_s"] for r in results]
    per_stream = [(len(r["tokens"]) - 1) / (r["latency_s"] - r["ttft_s"])
                  for r in results]
    out_tok_s = sum(len(r["tokens"]) for r in results) / wall
    log(f"  8/8 requests ({sum(len(p) for p in prompts)} prompt tokens, "
        f"lengths {[len(p) for p in prompts]}) in {wall:.2f} s; prefix "
        f"hits {hits}")
    log(f"  [{card}] TTFT median {statistics.median(ttft) * 1e3:.1f} ms, "
        f"max {max(ttft) * 1e3:.1f} ms")
    log(f"  [{card}] decode {statistics.median(per_stream):.1f} tokens/s "
        f"per stream (median), {out_tok_s:.1f} output tokens/s over the "
        f"phase")
    # prefill only: a 1500-token prompt (two chunks) asking for one token
    # completes at admission, with no decode step
    s3 = snap()
    engine.submit(prompt(1500), max_new_tokens=1).result(timeout=900)
    prefill = stretch(s3, snap(), "prefill-only stretch")
    if prefill["decode_steps"] or prefill["paged_prefill_chunks"] != 2:
        raise RuntimeError(f"prefill-only stretch counted {prefill}")
    by_path = {"burst": burst, "decode_only": decode,
               "prefill_only": prefill}
    for path, d in by_path.items():
        counts = ", ".join(f"{k.__name__} {d[k.__name__]}" for k in kernels)
        log(f"  launches, {path}: {d['paged_prefill_chunks']} prefill "
            f"chunks, "
            f"{d['decode_steps']} decode steps; {counts}")

    # repeat: the same prompt twice more, both through the prefix-hit path,
    # must give the same tokens
    rep = [engine.submit(prompts[2], adapter=names[2]).result(
        timeout=900)["tokens"] for _ in range(2)]
    if rep[0] != rep[1]:
        raise RuntimeError(f"repeat differs: {rep[0]} vs {rep[1]}")
    same_as_first = sum(a == b for a, b in zip(rep[0], results[2]["tokens"]))
    log(f"  repeat: identical twice; {same_as_first}/32 tokens equal to the "
        f"first run (which prefilled without a prefix hit)")
    return {"launches": launches, "launches_by_path": by_path,
            "launches_per_step": per_step, "recorder": recorder,
            "ttft_ms": [x * 1e3 for x in ttft],
            "decode_tok_s_per_stream": per_stream,
            "output_tok_s": out_tok_s, "wall_s": wall,
            "prompt_lengths": [len(p) for p in prompts],
            "prefix_hits": hits, "repeat_same_as_first": same_as_first,
            "tokens": [r["tokens"] for r in results],
            "prompts": prompts, "prompt": prompt}


def http_and_drain(engine, prompt) -> dict:
    """One request through the HTTP front, then drain: the pool must hold
    zero leaked pages."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve

    httpd = serve(engine, port=0, host="127.0.0.1")
    try:
        status, body = http_generate(httpd.server_address[1],
                                     {"tokens": prompt(100),
                                      "max_new_tokens": 8})
    finally:
        httpd.shutdown()
        httpd.server_close()
    if status != 200 or len(body.get("tokens", [])) != 8:
        raise RuntimeError(f"/generate answered {status}: {body}")
    log(f"  HTTP: POST /generate -> {status}, {len(body['tokens'])} tokens")
    engine.drain()
    deadline = time.monotonic() + 120
    while not engine.drained:
        if time.monotonic() > deadline:
            raise RuntimeError("engine did not drain")
        time.sleep(0.05)
    stats = engine.prefix_cache_stats()
    store = engine._kv_store
    nodes = list(store.trie._nodes.values())
    leaked = (store.pool.n_pages - store.pool.free_count - len(nodes)
              + sum(store.pool.refcount(n.page) - 1 for n in nodes))
    if leaked:
        raise RuntimeError(f"{leaked} pages leaked after drain: {stats}")
    log(f"  drained: {stats['pages_free']} free + {stats['nodes']} cached = "
        f"{stats['pages_total']} pages, 0 leaked")
    return {"http_status": status, "pool": stats, "leaked_pages": 0}


def engine_phase(torch, dev, card: str, cfg, params) -> dict:
    """The bf16 engine: burst, prefix path, independent check, HTTP,
    drain. Returns its record and the one-chunk last-token logits of the
    checked prompt (on the host) for the quantized engine to compare."""
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, max_new_tokens=32)
    engine = ServingEngine(cfg, params, sc, device=dev).start()
    try:
        log(f"  {cfg.name}: {cfg.n_layers} layers, E={cfg.embed_dim}, bf16; "
            f"arena {engine._kv_store.pool.n_pages} pages of 16 tokens, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        # the single-token forms lie on no model path: held at 0
        per_step = {"paged_attention_multi": cfg.n_layers,
                    "rms_norm": 2 * cfg.n_layers + 1,
                    "paged_attention": 0, "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (paged_attention_multi, rms_norm, paged_attention,
                           paged_attention_quant), per_step)
        prompts = rec.pop("prompts")
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card,
                                         ENGINE_REL_L2_LIMIT, "bf16 engine")
            one_chunk, prefix = prefix_path_check(torch, engine.model,
                                                  engine.params, prompts[2])
            reference = engine_reference_check(torch, cfg, engine.params,
                                               prompts[2], one_chunk)
        log(f"  prefix path (last-token logits, max abs diff): one chunk vs "
            f"cached prefix + tail {prefix['max_abs_diff']:.4f}; cached vs "
            f"uncached prefix, same tail chunk "
            f"{prefix['cache_vs_uncached_max_abs_diff']:.4f}; one chunk vs "
            f"two uncached chunks {prefix['two_chunk_max_abs_diff']:.4f} "
            f"(logit std {prefix['logit_std']:.4f}, top-1 margin "
            f"{prefix['top1_margin']:.4f}, argmax agree "
            f"{prefix['argmax_agree']})")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   prefix_path=prefix, reference=reference)
        return rec, one_chunk.cpu()
    finally:
        engine.stop()


# -- phase 7x: the replica's observability and fleet membership ---------------------

# the keys of every heartbeat's "stats", the JAX ReplicaReporter's set
REPORTER_STATS_KEYS = frozenset({
    "free_slots", "active_slots", "max_slots", "queue_depth",
    "max_queue_depth", "kv_cache_tokens", "ttft_p95_s", "itl_p95_s",
    "kv_pages_free", "kv_pages_total", "handoffs_total", "errors_total",
    "requests_total", "tokens_total", "prefix_hit_rate",
    "spec_acceptance_rate", "draining"})
# phase 7x (c): the tokens a request of the bursts that keep the slots
# busy while the profiler starts and its 1 s window runs
OBS_TRAFFIC_TOKENS = 64
# phase 7x (c): seconds a /debug/profile capture may take (they read 7-18
# s under traffic, NVIDIA H100 80GB HBM3, 700.00 W)
OBS_PROFILE_WATCHDOG_S = 240


def scrape(port: int) -> dict:
    """GET /metrics parsed: {sample name with its labels: value}, each
    bucket's exemplar suffix dropped."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        ctype = r.headers.get("Content-Type", "")
        text = r.read().decode()
    if ctype != "text/plain; version=0.0.4":
        raise RuntimeError(f"/metrics answered Content-Type {ctype!r}")
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.split(" # ")[0].rsplit(" ", 1)
            out[name] = float(value)
    return out


def stub_router():
    """A fleet router that records every POST: (httpd, its URL, the list of
    (path, body) it received, in order)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    posts, lock = [], threading.Lock()

    class Stub(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n)) if n else {}
            with lock:
                posts.append((self.path, body, time.monotonic()))
            reply = json.dumps({"registered": True, "ok": True}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(reply)))
            self.end_headers()
            self.wfile.write(reply)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}", posts


def http_post_tenant(port: int, path: str, body: dict, headers: dict) -> tuple:
    """(status, JSON body, response traceparent) of one POST."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                **headers})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read()), r.headers.get("traceparent")


def cost_checks(engine, port: int, posts: list, prompts: list,
                card: str) -> dict:
    """Phase 7x (f): the cost meter, on by default as in the JAX replica.
    Requests over HTTP under two ``X-Tenant`` values and one OpenAI
    ``user`` (``/v1/completions``), in turn; then ``GET /debug/costs``:
    each tenant's requests, its chip-seconds the sum of its requests'
    walls (their ``serving.request`` spans' latency) x 1 card within
    COST_WALL_TOL_S a request, its dollars chip-seconds x the ``h100``
    row's price / 3600, the spans carrying each request's chip-seconds
    and dollars, the replica priced as ``h100`` (the card's name); the
    first heartbeat after them carries the same ledger (the JAX fleet
    router folds it; held on the CPU, ``tests/test_torch_costmeter.py``,
    since this script imports nothing of the JAX package)."""
    import uuid

    from k8s_runpod_kubelet_tpu_torch.generations import cost_per_chip_hr
    from k8s_runpod_kubelet_tpu_torch.tracing import format_traceparent

    calls = [("/generate", {"tokens": prompts[0][:300], "max_new_tokens": 8},
              {"X-Tenant": "tenant-a"}, "tenant-a"),
             ("/generate", {"tokens": prompts[1][:200], "max_new_tokens": 8},
              {"X-Tenant": "tenant-b"}, "tenant-b"),
             ("/generate", {"tokens": prompts[3][:250], "max_new_tokens": 4},
              {"X-Tenant": "tenant-a"}, "tenant-a"),
             ("/v1/completions", {"prompt": prompts[4][:150],
                                  "max_tokens": 6, "user": "openai-user"},
              {}, "openai-user")]
    before = json.loads(http_json(f"http://127.0.0.1:{port}/debug/costs"))
    spans, t_sent = {}, time.monotonic()
    for path, body, headers, tenant in calls:
        tid = uuid.uuid4().hex
        st, _, _ = http_post_tenant(port, path, body, {
            **headers, "traceparent": format_traceparent(
                tid, uuid.uuid4().hex[:16])})
        if st != 200:
            raise RuntimeError(f"(f) {path} answered {st}")
        trace = json.loads(http_json(
            f"http://127.0.0.1:{port}/debug/traces?trace_id={tid}"))
        (root,) = [x for x in trace["spans"]
                   if x["name"] == "serving.request"]
        spans.setdefault(tenant, []).append(root["attrs"])
    after = json.loads(http_json(f"http://127.0.0.1:{port}/debug/costs"))
    price = cost_per_chip_hr("h100")
    if not (after["generation"] == "h100" and after["chips"] == 1
            and after["price_per_chip_hr"] == round(price, 6)):
        raise RuntimeError(f"(f) the replica priced as {after['generation']}"
                           f" at {after['price_per_chip_hr']} for "
                           f"{after['chips']} chips")
    rows = {}
    for tenant, attrs in spans.items():
        b = after["tenants"][tenant]
        a = before["tenants"].get(tenant, {"requests": 0,
                                           "chip_seconds": {},
                                           "cost_dollars": 0.0})
        chip_s = sum(b["chip_seconds"].values()) - sum(
            a["chip_seconds"].values())
        dollars = b["cost_dollars"] - a["cost_dollars"]
        walls = sum(x["latency_s"] for x in attrs)
        span_chip = sum(x["chip_seconds_queue"] + x["chip_seconds_prefill"]
                        + x["chip_seconds_decode"] for x in attrs)
        span_dollars = sum(x["cost_dollars"] for x in attrs)
        rows[tenant] = {"requests": b["requests"] - a["requests"],
                        "chip_seconds": chip_s, "walls_s": walls,
                        "dollars": dollars, "span_chip_seconds": span_chip,
                        "span_dollars": span_dollars}
        if not (rows[tenant]["requests"] == len(attrs)
                and all(x["tenant"] == tenant for x in attrs)
                and abs(chip_s - walls) <= COST_WALL_TOL_S * len(attrs)
                and abs(span_chip - chip_s) <= COST_WALL_TOL_S * len(attrs)
                and abs(dollars - chip_s * price / 3600) <= 1e-8
                and abs(span_dollars - dollars) <= 1e-8):
            raise RuntimeError(f"(f) tenant {tenant}: {rows[tenant]} "
                               f"(price {price} $/card-hr)")
    deadline = time.monotonic() + 10
    while True:
        beats = [b for p, b, at in list(posts)
                 if p == "/fleet/heartbeat" and at > t_sent]
        late = [b for b in beats if all(
            b.get("costs", {}).get("tenants", {}).get(t, {}).get("requests")
            == after["tenants"][t]["requests"] for t in spans)]
        if late:
            break
        if time.monotonic() > deadline:
            raise RuntimeError("(f) no heartbeat carried the ledger")
        time.sleep(0.05)
    beat = late[0]["costs"]
    log(f"  (f) [{card}] cost meter (on by default), priced "
        f"{after['generation']} at {after['price_per_chip_hr']} $/card-hr "
        f"(generations.py's list price): "
        + "; ".join(f"{t} {r['requests']} requests, {r['chip_seconds']:.6f} "
                    f"chip-s against walls {r['walls_s']:.6f} s, "
                    f"${r['dollars']:.9f}" for t, r in rows.items())
        + f"; the spans carry the same; a heartbeat carried the ledger "
        f"({beat['totals']['requests']} requests in all)")
    return {"tenants": rows, "price_per_chip_hr": after["price_per_chip_hr"],
            "generation": after["generation"], "snapshot": after,
            "heartbeat_requests": beat["totals"]["requests"],
            "tolerance_s": COST_WALL_TOL_S}


def http_burst(port: int, prompts: list, max_new: int, traces: list) -> list:
    """The prompts as concurrent POST /generate, request i carrying the
    caller traceparent ``traces[i]``: [(status, body, response
    traceparent)] in prompt order."""
    out = [None] * len(prompts)

    def one(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": prompts[i],
                             "max_new_tokens": max_new}).encode(),
            method="POST", headers={"Content-Type": "application/json",
                                    "traceparent": traces[i]})
        with urllib.request.urlopen(req, timeout=900) as r:
            out[i] = (r.status, json.loads(r.read()),
                      r.headers.get("traceparent"))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(o is None for o in out):
        raise RuntimeError("a burst request raised (see the thread's "
                           "traceback above)")
    return out


def span_tree_check(port: int, trace_id: str, parent: str,
                    root_id: str) -> dict:
    """(a) /debug/traces?trace_id= holds exactly the request's four spans:
    the root under the caller's span, its three children contiguous and
    summing to the root's duration within 1 ms."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/traces"
                                f"?trace_id={trace_id}", timeout=60) as r:
        spans = json.loads(r.read())["spans"]
    by = {s["name"]: s for s in spans}
    names = ("serving.request", "serving.queue_wait", "serving.prefill",
             "serving.decode")
    if len(spans) != 4 or set(by) != set(names):
        raise RuntimeError(f"(a) trace {trace_id}: spans "
                           f"{[s['name'] for s in spans]}")
    root = by["serving.request"]
    if root["span_id"] != root_id or root["parent_id"] != parent:
        raise RuntimeError(f"(a) root span {root['span_id']} under "
                           f"{root['parent_id']}, not {root_id} under "
                           f"{parent}")
    kids = [by[n] for n in names[1:]]
    if any(k["parent_id"] != root_id for k in kids):
        raise RuntimeError(f"(a) a child span is not under the root: {kids}")
    edges = [root["start"]] + [k["start"] + k["duration_s"] for k in kids]
    starts = [k["start"] for k in kids]
    gaps = [abs(a - b) for a, b in zip(edges[:-1], starts)]
    gaps.append(abs(edges[-1] - (root["start"] + root["duration_s"])))
    total = sum(k["duration_s"] for k in kids)
    if max(gaps) > 1e-3 or abs(total - root["duration_s"]) > 1e-3:
        raise RuntimeError(f"(a) children not contiguous (gaps {gaps}) or "
                           f"their sum {total} off the root's "
                           f"{root['duration_s']}")
    return {"spans": spans, "root": root,
            "children_sum_minus_root_s": total - root["duration_s"]}


def observability_phase(torch, dev, card: str, cfg, params,
                        base: dict) -> dict:
    """Phase 7x: phase 4's engine again, served the way a replica runs:
    ``serve_main.serve`` with profile capture on, its tracer exporting to
    a JSONL file, a ``ReplicaReporter`` at 0.5 s against a stub router.
    (a) phase 4's burst over HTTP with caller traceparents: each answer
    carries the caller's trace id, /debug/traces holds the four spans of
    each request (children contiguous, summing to the root), the roots'
    ``decode_steps`` sum to at least the burst's replays, and the export
    file holds the same spans; (b) /metrics deltas over the burst against
    the engine's own counts (admitted, decode steps = replays, prefill
    chunks, the shared prefix's hit, the histograms' counts, the
    recorder's step records, 0 recaptures) and the launches (32 and 65 a
    step or chunk); (c) /debug/profile?seconds=1 while bursts keep the
    slots busy: the trace's kernel events hold ``paged_attention_multi`` and
    ``rms_norm`` at 32 : 65 a step, within one step at each window edge;
    (d) the stub got one register and beats whose stats carry exactly the
    JAX reporter's keys and whose metrics snapshots (schema 1) agree with
    /metrics, and a deregister after the drain; (e) the burst's decode
    tokens/s per stream and (g3)'s replay wall beside phase 4's, reported;
    (f) the cost meter, on by default (``cost_checks``); then (g1)-(g5) on
    this engine."""
    import shutil
    import socket
    import uuid

    from k8s_runpod_kubelet_tpu_torch.fleet.registry import ReplicaReporter
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.tracing import (Tracer,
                                                      format_traceparent,
                                                      parse_traceparent)
    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        trace_kernel_events

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-7x-")
    export = os.path.join(tmp, "spans.jsonl")
    tracer = Tracer(export_path=export)
    sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, max_new_tokens=32)
    engine = ServingEngine(cfg, params, sc, device=dev, tracer=tracer).start()
    httpd = serve(engine, port=0, host="127.0.0.1", profile_capture=True)
    port = httpd.server_address[1]
    router, router_url, posts = stub_router()
    reporter = ReplicaReporter(engine, router_url, replica_id="chip-smoke-7x",
                               advertise_url=f"http://127.0.0.1:{port}",
                               pod_name=socket.gethostname(),
                               interval_s=0.5).start()
    kernels = (paged_attention_multi, rms_norm, paged_attention,
               paged_attention_quant)
    per_step = {"paged_attention_multi": cfg.n_layers,
                "rms_norm": 2 * cfg.n_layers + 1,
                "paged_attention": 0, "paged_attention_quant": 0}
    out = {}
    try:
        warm, prompts, _ = burst_prompts(cfg)
        status, _ = http_generate(port, {"tokens": warm,
                                         "max_new_tokens": 4})
        if status != 200:
            raise RuntimeError(f"warm-up answered {status}")

        def snap() -> dict:
            with engine._prefix_lock:
                return {"paged_prefill_chunks":
                        engine.counters["paged_prefill_chunks"],
                        "decode_steps": engine.counters["decode_steps"],
                        "replays": sum(g.fn.replays
                                       for g in engine._graphs()),
                        **{k.__name__: k.launches for k in kernels}}

        # (a)/(b): the burst over HTTP, counts set to 0 just before
        callers = [(uuid.uuid4().hex, uuid.uuid4().hex[:16])
                   for _ in prompts]
        m0 = scrape(port)
        with engine._prefix_lock:
            for k in kernels:
                k.launches = 0
        s0 = snap()
        seq0 = last_seq(engine)
        t0 = time.perf_counter()
        res = http_burst(port, prompts, 32,
                         [format_traceparent(t, s) for t, s in callers])
        wall = time.perf_counter() - t0
        s1 = snap()
        m1 = scrape(port)
        t_scrape = time.monotonic()
        launches = {k.__name__: k.launches for k in kernels}
        d = {k: s1[k] - s0[k] for k in s0}
        if any(st != 200 or len(b["tokens"]) != 32 for st, b, _ in res):
            raise RuntimeError(f"(a) burst answers {[r[0] for r in res]}")
        steps = d["paged_prefill_chunks"] + d["decode_steps"]
        for name, n in per_step.items():
            if d[name] != n * steps or (n and d[name] < 1):
                raise RuntimeError(f"7x: {name} launched {d[name]} times in "
                                   f"{steps} steps and chunks, not {n} each")
        roots, trees = [], []
        for (tid, parent), (_, body, tp) in zip(callers, res):
            got = parse_traceparent(tp)
            if got is None or got[0] != tid:
                raise RuntimeError(f"(a) response traceparent {tp!r} does "
                                   f"not carry the caller's trace {tid}")
            tree = span_tree_check(port, tid, parent, got[1])
            trees.append(tree)
            roots.append(tree["root"])
        steps_attr = sum(r["attrs"].get("decode_steps", 0) for r in roots)
        if steps_attr < d["replays"]:
            raise RuntimeError(f"(a) the roots' decode_steps sum to "
                               f"{steps_attr}, under the burst's "
                               f"{d['replays']} replays")
        per_stream = [(r["attrs"]["tokens"] - 1)
                      / (r["attrs"]["latency_s"] - r["attrs"]["ttft_s"])
                      for r in roots]
        worst = max(abs(t["children_sum_minus_root_s"]) for t in trees)
        log(f"  (a) 8/8 answers carry the caller's trace id; each trace: "
            f"serving.request + queue_wait, prefill, decode, contiguous "
            f"(children's sum off the root by at most {worst * 1e3:.6f} "
            f"ms); roots' decode_steps {steps_attr} >= {d['replays']} "
            f"replays")

        def delta(name: str) -> float:
            return m1.get(name, 0.0) - m0.get(name, 0.0)

        rec_steps = [r for r in engine.recorder.records()
                     if "wall_s" in r and r["seq"] > seq0]
        itl_want = sum(len(b["tokens"]) - 1 for _, b, _ in res)
        # the paged chunks as the kernel counts them, outside the metrics
        # store: each chunk and each replay launches row 8 once a layer
        chunks = (launches["paged_attention_multi"] // cfg.n_layers
                  - d["replays"])
        checks = {
            "tpu_serving_admitted_total": (delta("tpu_serving_admitted_total"),
                                           len(prompts)),
            "tpu_serving_decode_steps_total": (
                delta("tpu_serving_decode_steps_total"), d["replays"]),
            # the JAX engine's series: 0 with serving_chunk_tokens unset
            "tpu_serving_prefill_chunks_total": (
                delta("tpu_serving_prefill_chunks_total"), 0),
            "tpu_serving_paged_prefill_chunks_total": (
                delta("tpu_serving_paged_prefill_chunks_total"), chunks),
            "tpu_serving_ttft_seconds_count": (
                delta("tpu_serving_ttft_seconds_count"), len(prompts)),
            "tpu_serving_request_latency_seconds_count": (
                delta("tpu_serving_request_latency_seconds_count"),
                len(prompts)),
            "tpu_serving_queue_wait_seconds_count": (
                delta("tpu_serving_queue_wait_seconds_count"), len(prompts)),
            "tpu_serving_inter_token_seconds_count": (
                delta("tpu_serving_inter_token_seconds_count"), itl_want),
            "tpu_serving_step_wall_seconds_count": (
                delta("tpu_serving_step_wall_seconds_count"),
                len(rec_steps)),
        }
        bad = {k: v for k, v in checks.items() if v[0] != v[1]}
        hits = delta("tpu_serving_prefix_cache_hits_total")
        recompiles = {k: v for k, v in m1.items()
                      if k.startswith("tpu_serving_recompiles_total")}
        if bad or hits < 1 or chunks != len(prompts) \
                or len(recompiles) != len(engine._graphs()) \
                or any(recompiles.values()):
            raise RuntimeError(f"(b) /metrics against the engine: {bad}; "
                               f"prefix hits {hits}, chunks {d}, "
                               f"recompiles {recompiles}")
        log(f"  (b) /metrics deltas over the burst = the engine's counts: "
            + ", ".join(f"{k.replace('tpu_serving_', '')} {int(v[0])}"
                        for k, v in checks.items())
            + f"; prefix_cache_hits {int(hits)}; {recompiles}")
        log(f"  launches, 7x burst: {d['paged_prefill_chunks']} paged "
            f"prefill chunks, "
            f"{d['decode_steps']} decode steps; "
            + ", ".join(f"{k} {launches[k]}" for k in launches))
        out.update(launches=launches, counts=d, metrics_deltas={
            k: v[0] for k, v in checks.items()}, prefix_hits=hits,
            recompiles=recompiles, decode_steps_attr=steps_attr,
            burst_wall_s=wall, decode_tok_s_per_stream=per_stream)

        # (d) the beats: one register, beats with the JAX key set, and a
        # snapshot taken after the burst that agrees with /metrics
        deadline = time.monotonic() + 10
        while not any(p == "/fleet/heartbeat" and at > t_scrape + 0.05
                      for p, _, at in list(posts)):
            if time.monotonic() > deadline:
                raise RuntimeError("(d) no heartbeat after the burst")
            time.sleep(0.05)
        beats = [b for p, b, _ in list(posts) if p == "/fleet/heartbeat"]
        late = [b for p, b, at in list(posts)
                if p == "/fleet/heartbeat" and at > t_scrape + 0.05][0]
        registers = [b for p, b, _ in list(posts) if p == "/fleet/register"]
        keys_bad = [sorted(set(b["stats"]) ^ REPORTER_STATS_KEYS)
                    for b in beats if set(b["stats"]) != REPORTER_STATS_KEYS]
        schema_bad = [b["metrics"].get("schema_version") for b in beats
                      if b.get("metrics", {}).get("schema_version") != 1]
        snap_admitted = sum(v for n, _, v in late["metrics"]["counters"]
                            if n == "tpu_serving_admitted")
        if len(registers) != 1 or len(beats) < 2 or keys_bad or schema_bad \
                or snap_admitted != m1["tpu_serving_admitted_total"] \
                or late["stats"]["requests_total"] != snap_admitted:
            raise RuntimeError(
                f"(d) {len(registers)} registers, {len(beats)} beats, key "
                f"differences {keys_bad}, schemas {schema_bad}, admitted "
                f"{snap_admitted} vs /metrics "
                f"{m1['tpu_serving_admitted_total']}")
        log(f"  (d) stub router: 1 register ({registers[0]['role']}), "
            f"{len(beats)} heartbeats so far, each with the JAX reporter's "
            f"{len(REPORTER_STATS_KEYS)} stats keys and a schema-1 metrics "
            f"snapshot; the first beat after the burst: admitted "
            f"{int(snap_admitted)} = /metrics, requests_total "
            f"{late['stats']['requests_total']}, tokens_total "
            f"{late['stats']['tokens_total']}")

        # (f) the cost meter over HTTP, metered by tenant
        out["costs"] = cost_checks(engine, port, posts, prompts, card)

        # (c) the profile, taken while bursts keep the slots busy: the
        # window (and the profiler's start before it) lies inside traffic
        admitted0 = engine.counters["admitted"]
        stop, bursts = threading.Event(), []

        def traffic():
            while not stop.is_set():
                bursts.append(http_burst(
                    port, prompts, OBS_TRAFFIC_TOKENS,
                    [format_traceparent(uuid.uuid4().hex,
                                        uuid.uuid4().hex[:16])
                     for _ in prompts]))

        runner = threading.Thread(target=traffic)
        runner.start()
        try:
            deadline = time.monotonic() + 300
            while engine.counters["admitted"] - admitted0 < len(prompts):
                if time.monotonic() > deadline or not runner.is_alive():
                    raise RuntimeError("(c) the traffic was not admitted")
                time.sleep(0.002)
            steps0 = engine.counters["decode_steps"]
            t0 = time.perf_counter()
            # a capture that hangs dumps every thread's stack and ends the
            # script, instead of holding the card to the call's limit
            faulthandler.dump_traceback_later(OBS_PROFILE_WATCHDOG_S,
                                              exit=True)
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/debug/profile?seconds=1",
                        timeout=300) as r:
                    prof = json.loads(r.read())
            finally:
                faulthandler.cancel_dump_traceback_later()
            prof_wall = time.perf_counter() - t0
            steps_during = engine.counters["decode_steps"] - steps0
        finally:
            stop.set()
            runner.join()
        if not bursts or any(st != 200 for b in bursts for st, _, _ in b):
            raise RuntimeError("(c) a traffic burst failed")
        fams = trace_kernel_events(os.path.join(prof["profile_dir"],
                                                "trace.json"))
        shutil.rmtree(prof["profile_dir"], ignore_errors=True)
        attn = fams.get("paged_attention_multi", {"count": 0, "ms": 0.0})
        norm = fams.get("rms_norm", {"count": 0, "ms": 0.0})
        merge = fams.get("paged split merge", {"count": 0, "ms": 0.0})
        a_steps = attn["count"] / cfg.n_layers
        n_steps = norm["count"] / (2 * cfg.n_layers + 1)
        if attn["count"] < cfg.n_layers or norm["count"] < \
                2 * cfg.n_layers + 1 or abs(a_steps - n_steps) > 2:
            raise RuntimeError(f"(c) the profile's kernel events: "
                               f"paged_attention_multi {attn}, rms_norm "
                               f"{norm} ({a_steps:.2f} vs {n_steps:.2f} "
                               f"steps); families {sorted(fams)}; "
                               f"{prof_wall:.2f} s wall, {steps_during} "
                               "decode steps meanwhile")
        log(f"  (c) [{card}] /debug/profile?seconds=1 under bursts of "
            f"{OBS_TRAFFIC_TOKENS} tokens a request ({prof_wall:.2f} s wall, "
            f"{steps_during} decode steps meanwhile, {len(bursts)} bursts): "
            f"paged_attention_multi {attn['count']} events "
            f"({a_steps:.2f} steps or chunks of {cfg.n_layers}), "
            f"{attn['ms']:.3f} device ms "
            f"({attn['ms'] / max(1, attn['count']) * 1e3:.2f} us each); "
            f"rms_norm {norm['count']} ({n_steps:.2f} of "
            f"{2 * cfg.n_layers + 1}), {norm['ms']:.3f} device ms "
            f"({norm['ms'] / max(1, norm['count']) * 1e3:.2f} us each); "
            f"split-KV merges apart: {merge['count']}, {merge['ms']:.3f} ms")
        out["profile"] = {"paged_attention_multi": attn, "rms_norm": norm,
                          "paged_split_merge": merge,
                          "steps_by_attention": a_steps,
                          "steps_by_norm": n_steps, "wall_s": prof_wall,
                          "decode_steps_during": steps_during,
                          "bursts": len(bursts), "families": fams}

        # (g1)-(g5) on this engine, idle; (e) beside phase 4
        with engine._prefix_lock:
            out["graphs"] = graph_checks(torch, engine, card,
                                         ENGINE_REL_L2_LIMIT,
                                         "7x engine (observability on)")
        g3 = out["graphs"]["paged_step"]["g3_wall_ms"]
        g3_base = base["graphs"]["paged_step"]["g3_wall_ms"]
        log(f"  (e) [{card}] decode tokens/s per stream (median): 7x over "
            f"HTTP {statistics.median(per_stream):.1f}, phase 4 "
            f"{statistics.median(base['decode_tok_s_per_stream']):.1f}; "
            f"(g3) replay wall 7x {g3['graph']:.2f} / {g3['graph_2']:.2f} "
            f"ms, phase 4 {g3_base['graph']:.2f} / {g3_base['graph_2']:.2f}"
            f" ms (reported, not gated)")
        out["cost"] = {"decode_tok_s_per_stream_median":
                       statistics.median(per_stream),
                       "phase4_decode_tok_s_per_stream_median":
                       statistics.median(base["decode_tok_s_per_stream"]),
                       "g3_graph_ms": [g3["graph"], g3["graph_2"]],
                       "phase4_g3_graph_ms": [g3_base["graph"],
                                              g3_base["graph_2"]]}

        # the drain: the reporter deregisters once the engine has drained
        engine.drain()
        deadline = time.monotonic() + 60
        while not any(p == "/fleet/deregister" for p, _, _ in list(posts)):
            if time.monotonic() > deadline:
                raise RuntimeError("(d) no deregister after the drain")
            time.sleep(0.05)
        out["reporter"] = {"registers": 1, "beats": sum(
            1 for p, _, _ in posts if p == "/fleet/heartbeat"),
            "deregistered": True, "stats_keys": sorted(REPORTER_STATS_KEYS)}
        log(f"  (d) drained: the reporter deregistered after "
            f"{out['reporter']['beats']} heartbeats")
    finally:
        reporter.stop()
        httpd.shutdown()
        httpd.server_close()
        router.shutdown()
        router.server_close()
        engine.stop()
        tracer.close()
    try:
        with open(export) as f:
            exported = [json.loads(line) for line in f]
        for tree in trees:
            want = {(s["span_id"], s["name"]) for s in tree["spans"]}
            tid = tree["root"]["trace_id"]
            got = {(s["span_id"], s["name"]) for s in exported
                   if s["trace_id"] == tid}
            if got != want:
                raise RuntimeError(f"(a) the export file holds {got} for "
                                   f"trace {tid}, /debug/traces {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["exported_spans"] = len(exported)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  (a) the export file holds the same 4 spans of each of the 8 "
        f"traces ({len(exported)} spans in all); phase 7x in "
        f"{out['phase_s']:.1f} s")
    return out


# -- (g1)-(g5): the engine's step graphs ----------------------------------------------

def graphs_used_check(engine, what: str) -> dict:
    """(g5) every graph captured once and never again, and every decode
    and verify step of the engine's life so far one replay: no eager model
    step on the card's engine path."""
    snap = engine.graphs_snapshot()
    replays = sum(g["replays"] for g in snap.values())
    steps = engine.counters["decode_steps"]
    for name, g in snap.items():
        if g["compiles"] != 1 or g["recompiles"] or g["warned"]:
            raise RuntimeError(f"{what}: graph {name} captured "
                               f"{g['compiles']} times: {g}")
    if replays != steps:
        raise RuntimeError(f"{what}: {replays} replays for {steps} decode "
                           "steps (an eager step ran on the card)")
    return {"graphs": snap, "replays": replays, "decode_steps": steps}


def graph_checks(torch, engine, card: str, limit: float, what: str) -> dict:
    """(g1)-(g5) on an idle engine, its arena lock held by the caller, for
    each of its graphs (width 1; with speculation also K + 1): (g5) first,
    then over 8 slots of the burst's contexts in pages taken from the
    engine's own pool and filled with seeded random rows: (g1) two replays
    against the eager ``paged_verify_step`` on a copy of the arena (the
    second step with new tokens, lengths + K and a page that only its
    table names): logits and every arena section; (g2) the graph's kernel
    nodes by name (``StepGraph.kernels_in_graph``) against the launches
    the capture recorded; (g3) the step wall in turns, eager (five tensors
    built from the host's values, as the engine did before its graphs),
    graph, graph, eager; (g4) device memory around the capture. The
    logits are expected to agree exactly (the same kernels on the same
    inputs); where they do not, they are held to ``limit``, the engine's
    own limit against the f32 forward. An engine serving LoRA adapters
    runs every step with its stacks and the slots' ids mixed: slot i
    decodes with adapter i mod (max_adapters + 1), the base among them."""
    import numpy as np

    out = {"g5": graphs_used_check(engine, what)}
    store, model, params = engine._kv_store, engine.model, engine.params
    arena, dev = store.arena, engine.device
    t, cols, b = (engine.sc.kv_page_tokens, engine._slot_pages_max,
                  engine.sc.slots)
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ad_host = ad_dev = {}
    if engine.multi_lora_enabled:
        ids = (np.arange(b) % (engine.sc.max_adapters + 1)).astype(np.int32)
        ad_host = {"adapters": engine._adapters, "adapter_ids": ids}
        ad_dev = {"adapters": engine._adapters,
                  "adapter_ids": torch.from_numpy(ids).to(dev)}
        out["adapter_ids"] = ids.tolist()
    for tracked in engine._graphs():
        g, w = tracked.fn, tracked.fn.width
        lengths = np.array(GRAPH_LENGTHS[:b], np.int32)
        lengths[0] = 16 * t - w
        need = -(-(lengths + 2 * w) // t)
        pages = store.alloc_run(int(need.sum()))
        try:
            table = np.zeros((b, cols), np.int32)
            at = 0
            for i in range(b):
                table[i, :need[i]] = pages[at:at + need[i]]
                at += need[i]
            idx = torch.tensor(pages, device=dev)
            for name, a in arena.items():
                shape = (a.shape[0], len(pages)) + tuple(a.shape[2:])
                if a.dtype == torch.int8:
                    vals = torch.randint(-127, 128, shape, generator=gen,
                                         device=dev, dtype=torch.int8)
                elif name.endswith("scale"):
                    vals = torch.empty(shape, device=dev).uniform_(
                        0.005, 0.02, generator=gen)
                else:
                    vals = torch.randn(shape, generator=gen, device=dev)
                a[:, idx] = vals.to(a.dtype)

            def host(k):
                lens = lengths + k * w
                live = -(-(lens + w) // t)
                tab = np.where(np.arange(cols)[None] < live[:, None], table,
                               0).astype(np.int32)
                return (rng.integers(0, vocab, (b, w)).astype(np.int32),
                        lens, tab, np.ones(b, bool),
                        np.full(b, w, np.int32))

            def eager(arena_, h):
                toks, lens, tab, act, n_tok = (
                    torch.from_numpy(np.asarray(x)).to(dev) for x in h)
                if w == 1:
                    return model.paged_decode_step(
                        params, toks[:, 0], arena_, tab, lens, act,
                        **ad_dev)[0]
                return model.paged_verify_step(params, toks, arena_, tab,
                                               lens, act, n_tok,
                                               **ad_dev)[0]

            copy = {k: v.clone() for k, v in arena.items()}
            rows = []
            for k in (0, 1):
                h = host(k)
                got = g.run(params, arena, *h, **ad_host).clone()
                tok_t, lens_t, tab_t, act_t, n_t = (
                    torch.from_numpy(np.asarray(x)).to(dev) for x in h)
                want = model.paged_verify_step(params, tok_t, copy, tab_t,
                                               lens_t, act_t, n_t,
                                               **ad_dev)[0]
                if w == 1:
                    want = want[:, 0]
                torch.cuda.synchronize()
                diff = (got - want).abs().max().item()
                rel = ((got - want).norm() / want.norm()).item()
                # each section's largest difference over its largest
                # magnitude, a layer at a time (0 where bit-identical)
                sections = {name: 0.0 if torch.equal(arena[name], copy[name])
                            else max(((a.float() - c.float()).abs().max()
                                      / c.float().abs().max()).item()
                                     for a, c in zip(arena[name],
                                                     copy[name]))
                            for name in arena}
                rows.append({"step": k, "logits_max_abs_diff": diff,
                             "logits_rel_l2": rel,
                             "arena_rel_max_diff": sections,
                             "exact": diff == 0 and not any(
                                 sections.values())})
                if not rows[-1]["exact"] and not (
                        rel <= limit and max(sections.values()) <= limit):
                    raise RuntimeError(f"{what}: graph {tracked.name} off "
                                       f"the eager step: {rows[-1]}")
            del copy
            h = host(1)
            counts = g.kernels_in_graph()
            want = {k: g.launches_per_replay[k] for k in counts}
            if counts != want:
                raise RuntimeError(f"{what}: the graph {tracked.name} "
                                   f"holds {counts}, the capture recorded "
                                   f"{g.launches_per_replay}")

            def timed(fn) -> float:
                walls = []
                for _ in range(GRAPH_TIMED_STEPS):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                return statistics.median(walls) * 1e3

            turns = [timed(lambda: eager(arena, h)),
                     timed(lambda: g.run(params, arena, *h, **ad_host)),
                     timed(lambda: g.run(params, arena, *h, **ad_host)),
                     timed(lambda: eager(arena, h))]
        finally:
            store.release(pages)
        out[tracked.name] = {
            "width": w, "g1": rows, "g2_kernels_in_one_replay": counts,
            "g3_wall_ms": {"eager": turns[0], "graph": turns[1],
                           "graph_2": turns[2], "eager_2": turns[3]},
            "g4_capture_memory": g.capture_memory}
        mem = g.capture_memory
        mixed = (f", adapter ids {out['adapter_ids']}"
                 if "adapter_ids" in out else "")
        log(f"  (g1) {what} {tracked.name} (K={w}) replay vs eager "
            f"paged_verify_step{mixed}, two steps: logits max abs "
            f"{[r['logits_max_abs_diff'] for r in rows]}, arena sections "
            f"equal {[r['exact'] for r in rows]}; (g2) kernel nodes a "
            f"replay launches, by name {counts}")
        log(f"  (g3) [{card}] step wall eager / graph / graph / eager: "
            + " / ".join(f"{x:.2f}" for x in turns) + " ms; (g4) capture: "
            f"allocated {mem['allocated_before'] / 2**30:.3f} -> "
            f"{mem['allocated_after'] / 2**30:.3f} GiB, max allocated "
            f"{mem['peak_before'] / 2**30:.3f} -> "
            f"{mem['peak_after'] / 2**30:.3f} GiB, reserved "
            f"{mem['reserved_before'] / 2**30:.3f} -> "
            f"{mem['reserved_after'] / 2**30:.3f} GiB")
    final = engine.graphs_snapshot()
    if any(g["compiles"] != 1 for g in final.values()):
        raise RuntimeError(f"{what}: the checks recaptured: {final}")
    log(f"  (g5) {what}: graphs {sorted(final)} captured once each, 0 "
        f"recaptures; {out['g5']['replays']} replays = "
        f"{out['g5']['decode_steps']} decode steps")
    return out


# -- phases 7s-7h: speculative decoding and chunk interleave, HF loading --------------

def self_mapped_tokens(torch, cfg, params, chunk: int = 8192) -> list:
    """Tokens t whose context t^N the model continues with t itself, best
    margin first: [(t, f32 margin of t over the runner-up)]. In a context
    of one token repeated every position sees N identical K/V rows, so
    attention returns that token's V row whatever its weights, every
    position's hidden state is the one-token context's, and the greedy
    next token f(t) is the same for every N. This sweeps f over the vocab
    without attention (o = V of the token, each kv head read by its q
    group), in bf16 like the engine, ``chunk`` tokens at a time."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops import rms_norm

    lp, eps, dt = params["layers"], cfg.norm_eps, cfg.dtype
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    group = cfg.n_heads // hkv
    head = (params["tok_embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    found = []
    for start in range(0, cfg.vocab_size, chunk):
        ids = torch.arange(start, min(start + chunk, cfg.vocab_size),
                           device=params["tok_embed"].device)
        x = params["tok_embed"][ids].to(dt)
        n = x.shape[0]
        for layer in range(cfg.n_layers):
            h = rms_norm(x, lp["attn_norm"][layer], eps)
            v = (h @ lp["wv"][layer].to(dt)).view(n, hkv, 1, hd)
            o = v.expand(n, hkv, group, hd).reshape(n, -1)
            x = x + o @ lp["wo"][layer].to(dt)
            h = rms_norm(x, lp["mlp_norm"][layer], eps)
            x = x + (F.silu(h @ lp["w_gate"][layer].to(dt))
                     * (h @ lp["w_up"][layer].to(dt))) @ lp["w_down"][layer] \
                .to(dt)
        logits = (rms_norm(x, params["final_norm"], eps) @ head.to(dt)) \
            .float()
        top2 = logits.topk(2, dim=-1)
        hit = top2.indices[:, 0] == ids
        for i in hit.nonzero().flatten().tolist():
            found.append((int(ids[i]), float(top2.values[i, 0]
                                             - top2.values[i, 1])))
        del logits, top2
    return sorted(found, key=lambda tm: -tm[1])


class TokenClock(threading.Thread):
    """Host times at which each request's generated-token count rose,
    sampled from the engine's slots every millisecond; and the time the
    engine's prefilled-token counter first reached ``prefill_target``."""

    def __init__(self, engine):
        super().__init__(name="token-clock", daemon=True)
        self.engine = engine
        self.times: dict = {}
        self.counts: dict = {}
        self.prefill_target = None
        self.prefill_done_at = None
        self.halt = threading.Event()

    def run(self):
        eng = self.engine
        while not self.halt.is_set():
            now = time.perf_counter()
            for slot in eng._slots:
                r = slot.request
                n = len(slot.generated)
                if r is not None and n > self.counts.get(r.rid, 0):
                    self.counts[r.rid] = n
                    self.times.setdefault(r.rid, []).append(now)
            if (self.prefill_target is not None
                    and self.prefill_done_at is None
                    and eng.counters["paged_prefill_tokens"]
                    >= self.prefill_target):
                self.prefill_done_at = now
            time.sleep(0.001)

    def largest_gaps(self, start: float, end: float) -> dict:
        """Per request decoding through [start, end]: the largest interval
        between two consecutive token arrivals that overlaps it, in ms."""
        out = {}
        for rid, ts in self.times.items():
            if ts[0] >= start or ts[-1] <= end:
                continue
            gaps = [b - a for a, b in zip(ts, ts[1:]) if b > start and a < end]
            out[rid] = max(gaps) * 1e3
        return out


def spec_traffic(cfg, params, torch) -> dict:
    """The speculative phase's seeded traffic: 4 repetitive prompts of
    400-800 tokens, the first 4 of ``burst_prompts`` (drafts get rejected
    there), one sampled request and one 1500-token prompt. Random weights
    do not copy from their context, so a repeated 24-token phrase (two of
    the four) gives the drafts almost nothing the model will write; the
    other two repeat one token the model maps to itself
    (``self_mapped_tokens``, best margin first; a seeded token where the
    sweep finds fewer), whose continuation is that token again, so those
    streams' drafts are accepted."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    _, burst, _ = burst_prompts(cfg)
    t0 = time.perf_counter()
    fixed = self_mapped_tokens(torch, cfg, params)
    sweep_s = time.perf_counter() - t0
    tokens = [t for t, _ in fixed[:2]]
    while len(tokens) < 2:
        tokens.append(int(rng.integers(0, cfg.vocab_size)))
    lengths = [int(n) for n in rng.integers(400, 801, 4)]
    rep = [[t] * n for t, n in zip(tokens, lengths)]
    for n in lengths[2:]:
        phrase = [int(x) for x in rng.integers(0, cfg.vocab_size, 24)]
        rep.append((phrase * (n // 24 + 1))[:n])
    sampled = [int(x) for x in rng.integers(0, cfg.vocab_size, 300)]
    long_prompt = [int(x) for x in rng.integers(0, cfg.vocab_size, 1500)]
    return {"greedy": rep + burst[:4], "sampled": sampled,
            "long": long_prompt, "self_mapped": fixed[:8],
            "repeated_tokens": tokens, "sweep_s": sweep_s}


def spec_run(torch, engine, traffic, kernels, per_step, card: str) -> dict:
    """One engine over the traffic: the 8 greedy requests and the sampled
    one (64 new tokens each; 9 requests on 8 slots), then, once all 9
    prompts are prefilled, the 1500-token prompt beside the streams still
    decoding. Launch counts are set to 0 just before and read just after,
    each against the engine's own steps and chunks; the token clock reads
    each stream's largest token gap while the long prompt prefills."""
    snap_keys = ("decode_steps", "paged_prefill_chunks",
                 "paged_speculative_steps", "spec_proposed", "spec_accepted",
                 "paged_speculative_rollback_pages",
                 "chunk_interleaved_steps", "paged_prefill_tokens")

    def snap() -> dict:
        with engine._prefix_lock:
            return {**{k: engine.counters[k] for k in snap_keys},
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    with engine._prefix_lock:
        for k in kernels:
            k.launches = 0
    clock = TokenClock(engine)
    clock.start()
    try:
        s0 = snap()
        seq0 = last_seq(engine)
        t0 = time.perf_counter()
        futs = [engine.submit(p, max_new_tokens=64)
                for p in traffic["greedy"]]
        futs.append(engine.submit(traffic["sampled"], max_new_tokens=64,
                                  temperature=0.8, seed=SEED))
        deadline = time.monotonic() + 600
        while True:
            with engine._transit_lock:   # nothing queued or prefilling
                prefilled = engine.queue_depth == 0 and engine._transit == 0
            if prefilled and engine.active_slots:
                break
            if time.monotonic() > deadline:
                raise RuntimeError("the 9 prompts did not prefill")
            time.sleep(0.001)
        clock.prefill_target = (engine.counters["paged_prefill_tokens"]
                                + len(traffic["long"]))
        t_long = time.perf_counter()
        futs.append(engine.submit(traffic["long"], max_new_tokens=64))
        results = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        s1 = snap()
    finally:
        clock.halt.set()
        clock.join(timeout=10)
    if clock.prefill_done_at is None:
        raise RuntimeError("the token clock missed the long prefill's end")
    d = {k: s1[k] - s0[k] for k in s0}
    steps = d["decode_steps"] + d["paged_prefill_chunks"]
    if d["replays"] != d["decode_steps"]:
        raise RuntimeError(f"{d['replays']} graph replays for "
                           f"{d['decode_steps']} decode steps")
    for name, n in per_step.items():
        if d[name] != n * steps or (n and d[name] < 1):
            raise RuntimeError(
                f"{name} launched {d[name]} times in "
                f"{d['paged_prefill_chunks']} chunks and {d['decode_steps']} decode steps "
                f"({d['paged_speculative_steps']} of them verify steps), "
                f"not {n} per step")
    if any(len(r["tokens"]) != 64 for r in results):
        raise RuntimeError("not every request finished with 64 tokens")
    gaps = clock.largest_gaps(t_long, clock.prefill_done_at)
    per_stream = [63 / (r["latency_s"] - r["ttft_s"]) for r in results]
    k = engine.sc.speculate_k
    recorder = recorder_stats(
        engine, seq0, f"7s run (speculate_k {k}, serving_chunk_tokens "
        f"{engine.sc.serving_chunk_tokens})", card)
    return {"tokens": [r["tokens"] for r in results], "counts": d,
            "recorder": recorder,
            "wall_s": wall, "decode_tok_s_per_stream": per_stream,
            "ttft_ms": [r["ttft_s"] * 1e3 for r in results],
            "long_prefill_ms": (clock.prefill_done_at - t_long) * 1e3,
            "largest_gap_ms": sorted(gaps.values()),
            "streams_in_window": len(gaps)}


def verify_logits_check(torch, cfg, model, params) -> dict:
    """(a) ``paged_verify_step`` at K = SPEC_K + 1, B = 8 over a table
    whose slots 0-3 share a 96-token prefix's pages, against a plain f32
    forward of each slot's whole sequence: each of the K rows within the
    bf16 engine's relative L2 limit."""
    import numpy as np

    dev, t, cols, kk = model.device, 16, 2048 // 16, SPEC_K + 1
    rng = np.random.default_rng(SEED + 2)

    def toks(n):
        return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

    shared = toks(96)
    seqs = [shared + toks(int(n)) for n in rng.integers(40, 400, 4)]
    seqs += [toks(int(n)) for n in rng.integers(100, 700, 4)]
    drafts = [toks(kk) for _ in seqs]
    pages_of = [-(-(len(s) + kk) // t) for s in seqs]
    n_pages = sum(pages_of)
    arena = model.init_paged_arena(n_pages, t)
    table = torch.zeros((8, cols), dtype=torch.int32)
    prefix_pages = list(range(96 // t))
    nxt = len(prefix_pages)
    for i, s in enumerate(seqs):
        own = pages_of[i] - (len(prefix_pages) if i < 4 else 0)
        row = (prefix_pages if i < 4 else []) + list(range(nxt, nxt + own))
        nxt += own
        table[i, :len(row)] = torch.tensor(row)
    table = table.to(dev)

    def prefill(i, start, stop):
        ids = torch.tensor([seqs[i][start:stop]], dtype=torch.int32,
                           device=dev)
        model.paged_prefill_chunk_step(
            params, ids, arena, table[i:i + 1],
            torch.tensor([start], dtype=torch.int32, device=dev),
            torch.tensor([stop - start], dtype=torch.int32, device=dev))

    prefill(0, 0, 96)                 # the shared pages, written once
    for i, s in enumerate(seqs):
        prefill(i, 96 if i < 4 else 0, len(s))
    logits, _ = model.paged_verify_step(
        params, torch.tensor(drafts, dtype=torch.int32, device=dev), arena,
        table, torch.tensor([len(s) for s in seqs], dtype=torch.int32,
                            device=dev),
        n_tokens=torch.full((8,), kk, dtype=torch.int32, device=dev))
    worst, rows = 0.0, []
    for i, s in enumerate(seqs):
        ids = torch.tensor([s + drafts[i]], device=dev)
        ref = plain_logits(torch, cfg, params, ids)[0, -kk:]
        rel = ((logits[i] - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()
        rows.append(rel)
        worst = max(worst, max(rel))
    log(f"  (a) verify K={kk} B=8 (slots 0-3 share 6 prefix pages) vs plain "
        f"f32 forward: worst row relative L2 {worst:.4f} (limit "
        f"{ENGINE_REL_L2_LIMIT})")
    if not worst <= ENGINE_REL_L2_LIMIT:
        raise RuntimeError(f"verify rows off the plain forward: {rows}")
    return {"rows_rel_l2": rows, "worst": worst,
            "limit": ENGINE_REL_L2_LIMIT,
            "lengths": [len(s) for s in seqs]}


def divergence_check(torch, cfg, params, prompts, spec, plain,
                     reference=None) -> dict:
    """(b) each greedy request's tokens, speculative against not: equal up
    to the first divergence, and there the plain f32 forward's top-2
    margin on the common context must be under SPEC_TIE_MARGIN of its
    logits' RMS (a near-tie the two bf16 paths may break either way).
    ``reference`` (torch, cfg, params, tokens) -> last-token f32 logits
    is that forward (``reference_logits`` by default)."""
    reference = reference or reference_logits
    out = []
    for prompt, a, b in zip(prompts, spec, plain):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if n is None:
            continue
        ref = reference(torch, cfg, params, prompt + b[:n])
        top2 = ref.topk(2).values
        margin = (top2[0] - top2[1]).item()
        rms = ref.pow(2).mean().sqrt().item()
        out.append({"prompt_tokens": len(prompt), "at": n,
                    "margin": margin, "logit_rms": rms,
                    "margin_share": margin / rms})
        if not margin < SPEC_TIE_MARGIN * rms:
            raise RuntimeError(
                f"greedy tokens diverge at {n} of a {len(prompt)}-token "
                f"prompt where the f32 top-2 margin is {margin:.4f}, "
                f"{margin / rms:.3f} of the logits' RMS (tie margin "
                f"{SPEC_TIE_MARGIN})")
    return {"divergences": out, "count": len(out),
            "tie_margin": SPEC_TIE_MARGIN}


def spec_engine_phase(torch, dev, card: str, cfg, params) -> dict:
    """Speculative decoding and chunk interleave on llama3-8b bf16 (the
    engine phase's params): checks (a)-(e) and the reported rates."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    model = LlamaModel(cfg, dev)
    traffic = spec_traffic(cfg, params, torch)
    log(f"  traffic: self-mapped tokens (token, f32 margin) "
        f"{traffic['self_mapped']} in a {traffic['sweep_s']:.1f} s sweep of "
        f"the vocab; 4 repetitive prompts "
        f"{[len(p) for p in traffic['greedy'][:4]]} tokens (tokens "
        f"{traffic['repeated_tokens']} repeated, then two 24-token phrases "
        f"repeated), 4 burst prompts "
        f"{[len(p) for p in traffic['greedy'][4:]]}, 1 sampled, 1 of 1500")
    verify = verify_logits_check(torch, cfg, model, params)
    kernels = (paged_attention_multi, rms_norm, paged_attention,
               paged_attention_quant, paged_attention_multi_quant)
    per_step = {"paged_attention_multi": cfg.n_layers,
                "rms_norm": 2 * cfg.n_layers + 1, "paged_attention": 0,
                "paged_attention_quant": 0, "paged_attention_multi_quant": 0}
    runs = {}
    # speculative and plain in turns (ABBA): walls move with the host
    for name, k, chunk in (("speculative", SPEC_K, SPEC_CHUNK),
                           ("plain", 0, SPEC_CHUNK),
                           ("plain_2", 0, SPEC_CHUNK),
                           ("speculative_2", SPEC_K, SPEC_CHUNK),
                           ("speculative_no_interleave", SPEC_K, 0)):
        sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                           kv_page_tokens=16, max_new_tokens=64,
                           speculate_k=k, serving_chunk_tokens=chunk)
        engine = ServingEngine(cfg, params, sc, device=dev).start()
        try:
            engine.submit(traffic["sampled"][:64],
                          max_new_tokens=4).result(timeout=900)   # warm-up
            rec = spec_run(torch, engine, traffic, kernels, per_step, card)
            if name == "speculative":
                with engine._prefix_lock:   # idle: every request done
                    rec["graphs"] = graph_checks(
                        torch, engine, card, ENGINE_REL_L2_LIMIT,
                        "speculative engine")
                rec["drain"] = http_and_drain(engine,
                                              burst_prompts(cfg)[2])
        finally:
            engine.stop()
        c = rec["counts"]
        log(f"  [{card}] {name} (speculate_k {k}, serving_chunk_tokens "
            f"{chunk}): {c['decode_steps']} decode steps "
            f"({c['paged_speculative_steps']} verify), "
            f"{c['paged_prefill_chunks']} chunks, accepted "
            f"{c['spec_accepted']} of {c['spec_proposed']} drafts, rollback pages "
            f"{c['paged_speculative_rollback_pages']}, interleaved steps "
            f"{c['chunk_interleaved_steps']}; decode "
            f"{statistics.median(rec['decode_tok_s_per_stream']):.1f} "
            f"tokens/s per stream (median), wall {rec['wall_s']:.2f} s; "
            f"1500-token prefill {rec['long_prefill_ms']:.1f} ms, largest "
            f"token gap of the {rec['streams_in_window']} streams decoding "
            f"through it {max(rec['largest_gap_ms'], default=0):.1f} ms")
        runs[name] = rec
    spec, plain = runs["speculative"], runs["plain"]
    c = spec["counts"]
    for what, n in (("spec_accepted", c["spec_accepted"]),
                    ("paged_speculative_rollback_pages",
                     c["paged_speculative_rollback_pages"]),
                    ("chunk_interleaved_steps",
                     c["chunk_interleaved_steps"])):
        if not n > 0:
            raise RuntimeError(f"(c) {what} is {n}")
    greedy = traffic["greedy"] + [traffic["long"]]
    pick = list(range(8)) + [9]        # the sampled request is index 8
    div = divergence_check(torch, cfg, params, greedy,
                           [spec["tokens"][i] for i in pick],
                           [plain["tokens"][i] for i in pick])
    same_sampled = spec["tokens"][8] == plain["tokens"][8]
    log(f"  (b) greedy tokens, speculative vs plain: {div['count']} of 9 "
        f"requests diverge, each at a near-tie (f32 top-2 margin shares "
        f"{[round(x['margin_share'], 4) for x in div['divergences']]}, "
        f"limit {SPEC_TIE_MARGIN}); the sampled request "
        f"{'equal' if same_sampled else 'differs'} (not gated)")
    rate = c["spec_accepted"] / max(1, c["spec_proposed"])
    log(f"  (c) acceptance {c['spec_accepted']}/{c['spec_proposed']} = "
        f"{rate:.4f}; (d) launches exact per step and chunk; (e) drained "
        f"with 0 leaked pages")
    return {"self_mapped": traffic["self_mapped"],
            "repeated_tokens": traffic["repeated_tokens"],
            "verify_check": verify,
            "divergence": div, "sampled_equal": same_sampled,
            "acceptance_rate": rate, "runs": runs,
            "launches_per_step": per_step}


def recorder_overhead_phase(torch, dev, card: str, cfg, params) -> dict:
    """(f) Phase 4's burst four times more on fresh engines, the flight
    recorder off, on, on, off (turns, since walls move with the host).
    Reported: each burst's wall, per-stream decode tokens/s and TTFT
    medians."""
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    per_step = {"paged_attention_multi": cfg.n_layers,
                "rms_norm": 2 * cfg.n_layers + 1,
                "paged_attention": 0, "paged_attention_quant": 0}
    out = {}
    for name, on in (("recorder_off", False), ("recorder_on", True),
                     ("recorder_on_2", True), ("recorder_off_2", False)):
        sc = ServingConfig(slots=8, cache_len=2048, max_prefill_len=1024,
                           kv_page_tokens=16, max_new_tokens=32,
                           flight_recorder=on)
        engine = ServingEngine(cfg, params, sc, device=dev).start()
        try:
            if (engine.recorder is None) == on:
                raise RuntimeError(f"flight_recorder={on} engine has "
                                   f"recorder {engine.recorder}")
            rec = serve_burst(torch, engine, cfg, card,
                              (paged_attention_multi, rms_norm,
                               paged_attention, paged_attention_quant),
                              per_step)
        finally:
            engine.stop()
        out[name] = {k: rec[k] for k in ("wall_s", "decode_tok_s_per_stream",
                                         "ttft_ms", "recorder")}
        log(f"  (f) [{card}] burst with flight_recorder {on}: wall "
            f"{rec['wall_s']:.3f} s, decode "
            f"{statistics.median(rec['decode_tok_s_per_stream']):.1f} "
            f"tokens/s per stream (median), TTFT median "
            f"{statistics.median(rec['ttft_ms']):.1f} ms")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 7o: the OpenAI front, the dense-scratch route and embeddings --------------

# logit_bias +100 (OpenAI's largest) on these byte ids: a random-weight
# model then writes ASCII text through the byte tokenizer
OPENAI_BIAS_BYTES = b"aeiou st"


def http_post(port: int, path: str, body: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_ok(port: int, path: str, body: dict) -> dict:
    status, raw = http_post(port, path, body)
    if status != 200:
        raise RuntimeError(f"POST {path} answered {status}: {raw[:400]}")
    return json.loads(raw)


def wait_for(cond, what: str, timeout: float = 600) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting: {what}")
        time.sleep(0.001)


def clear_trie(engine) -> None:
    """Evict every unpinned trie page, so the next prompt finds no cached
    prefix (a route's TTFT is then measured from scratch)."""
    with engine._prefix_lock:
        while engine._kv_store.trie._evict_lru():
            pass


def biased_divergence(torch, cfg, params, prompt, a, b, bias) -> dict:
    """Two greedy token lists of one prompt under one logit_bias: equal up
    to any first divergence, where the plain f32 forward's top-2 margin
    (bias added) must be under SPEC_TIE_MARGIN of its logits' RMS."""
    n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None:
        return {"diverge_at": None, "compared": min(len(a), len(b))}
    ref = reference_logits(torch, cfg, params, prompt + a[:n])
    rms = ref.pow(2).mean().sqrt().item()
    biased = ref.clone()
    for t, v in bias.items():
        biased[int(t)] += v
    top2 = biased.topk(2).values
    margin = (top2[0] - top2[1]).item()
    if not margin < SPEC_TIE_MARGIN * rms:
        raise RuntimeError(f"greedy tokens diverge at {n} where the f32 "
                           f"top-2 margin is {margin / rms:.3f} of the "
                           f"logits' RMS (tie margin {SPEC_TIE_MARGIN})")
    return {"diverge_at": n, "margin_share": margin / rms}


def dense_route_forced(torch, engine, cfg, params, prompt,
                       **ref_kw) -> dict:
    """(a) Two 2040-token prompts whose page runs hold the whole pool
    (2 x 128 pages) and decode to their 2048-position budget; the engine
    thread is held at the first one's first token (its on_token waits)
    until the second is prefilled and a 1500-token prompt has found no
    up-front run and prefilled through the dense route; then all three
    run on, the third bound once a slot frees its pages. ``ref_kw`` go to
    the route's ``engine_reference_check`` (its limit, whether it gates)."""
    big = [prompt(2040), prompt(2040)]
    third = prompt(1500)
    entered, gate = threading.Event(), threading.Event()

    def hold(_tok):
        if not entered.is_set():
            entered.set()
            gate.wait(600)

    dense0 = engine.counters["dense_prefills"]
    f1 = engine.submit(big[0], max_new_tokens=8, on_token=hold)
    try:
        wait_for(entered.is_set, "the first 2040-token request's admission")
        f2 = engine.submit(big[1], max_new_tokens=8)
        wait_for(lambda: engine._ready.qsize() == 1,
                 "the second 2040-token prefill")
        free = engine._kv_store.pool.free_count
        t0 = time.perf_counter()
        f3 = engine.submit(third, max_new_tokens=8)
        wait_for(lambda: engine._ready.qsize() == 2,
                 "the 1500-token prefill")
        prefill_s = time.perf_counter() - t0
    finally:
        gate.set()
    results = [f.result(timeout=900) for f in (f1, f2, f3)]
    dense = engine.counters["dense_prefills"] - dense0
    if dense != 1 or any(len(r["tokens"]) != 8 for r in results):
        raise RuntimeError(f"(a) dense route taken {dense} times; tokens "
                           f"{[len(r['tokens']) for r in results]}")
    # the route's first-token logits again, on the now idle engine: the
    # same dense prefill (its pages were never cached: the pool was full)
    logits, _, matched = engine._prefill_tokens(third, single_only=True)
    if matched or int(logits[0].argmax()) != results[2]["tokens"][0]:
        raise RuntimeError(f"(a) the dense prefill repeated differently "
                           f"(matched {matched})")
    with engine._prefix_lock:
        check = engine_reference_check(torch, cfg, params, third,
                                       logits[0].float(),
                                       what="dense-route prefill", **ref_kw)
    log(f"  (a) pool full ({free} free pages of "
        f"{engine._kv_store.pool.n_pages}): the 1500-token prompt took the "
        f"dense route, prefilled in {prefill_s * 1e3:.1f} ms, bound when a "
        f"slot freed (TTFT {results[2]['ttft_s'] * 1e3:.1f} ms); all 3 "
        f"requests finished, none EngineOverloaded")
    return {"free_pages_at_arrival": free, "dense_prefill_ms": prefill_s * 1e3,
            "ttft_ms": [r["ttft_s"] * 1e3 for r in results],
            "reference": check}


def route_ttft(engine, prompt) -> dict:
    """TTFT of one 1500-token prompt through the native route (n = 1) and
    the dense route (an n = 2 group), in turns (native, dense, dense,
    native), each from an empty trie, one new token each."""
    out = {"native": [], "dense": []}
    for route in ("native", "dense", "dense", "native"):
        clear_trie(engine)
        if route == "native":
            r = engine.submit(prompt, max_new_tokens=1).result(timeout=900)
        else:
            r = [f.result(timeout=900)
                 for f in engine.submit_group(prompt, 2, max_new_tokens=1)][0]
        out[route].append(r["ttft_s"] * 1e3)
    return out


def openai_phase(torch, dev, card: str, cfg, params) -> dict:
    """Phase 7o: llama3-8b bf16 (phase 4's params) behind the OpenAI
    front, 2 slots, cache_len 2048, the pool at its minimum (2 x 128
    pages), the byte tokenizer: (a) the dense route forced, (b) chat with
    n = 2, a stop string, logprobs, (c) SSE, (d) embeddings, (e) every
    kernel launch accounted for by the engine's own counters and (g1)-(g5)
    on its graphs, then HTTP and drain with zero leaked pages."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.ops import (flash_fwd, paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serve_main import serve
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)
    from k8s_runpod_kubelet_tpu_torch.workloads.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    sc = ServingConfig(slots=2, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, kv_pool_pages=256,
                       max_new_tokens=16, eos_token=tok.eos_id)
    engine = ServingEngine(cfg, params, sc, device=dev,
                           decode_fn=tok.decode).start()
    rng = np.random.default_rng(SEED + 4)

    def prompt(n: int) -> list[int]:
        return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

    kernels = (flash_fwd, rms_norm, paged_attention_multi, paged_attention,
               paged_attention_quant, paged_attention_multi_quant)
    keys = ("decode_steps", "paged_prefill_chunks", "dense_prefills",
            "dense_prefill_heads", "dense_prefill_chunks", "embeds",
            "admission_rejected")

    def snap() -> dict:
        with engine._prefix_lock:
            return {**{k: engine.counters[k] for k in keys},
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    bias = {str(b): 100 for b in OPENAI_BIAS_BYTES}
    out = {}
    try:
        engine.submit(prompt(64), max_new_tokens=4).result(timeout=900)
        with engine._prefix_lock:
            for k in kernels:
                k.launches = 0
        s0 = snap()
        out["a"] = dense_route_forced(torch, engine, cfg, params, prompt)
        ttft = route_ttft(engine, prompt(1500))
        out["ttft_1500_ms"] = ttft
        log(f"  [{card}] TTFT of a 1500-token prompt, idle engine, empty "
            f"trie: native route {ttft['native'][0]:.1f} / "
            f"{ttft['native'][1]:.1f} ms, dense route (n = 2) "
            f"{ttft['dense'][0]:.1f} / {ttft['dense'][1]:.1f} ms")

        httpd = serve(engine, port=0, tokenizer=tok, host="127.0.0.1")
        port = httpd.server_address[1]
        try:
            out["b"] = openai_chat_checks(torch, engine, cfg, params, port,
                                          tok, bias)
            out["c"] = openai_stream_check(port, bias)
            out["d"] = embeddings_check(torch, engine, cfg, params, port,
                                        prompt)
        finally:
            httpd.shutdown()
            httpd.server_close()
        s1 = snap()
        d = {k: s1[k] - s0[k] for k in s0}
        heads = d["dense_prefill_heads"] + d["embeds"]
        steps = d["decode_steps"] + d["paged_prefill_chunks"]
        want = {"flash_fwd": cfg.n_layers * heads,
                "rms_norm": (2 * cfg.n_layers + 1)
                * (steps + heads + d["dense_prefill_chunks"]),
                "paged_attention_multi": cfg.n_layers * steps,
                "paged_attention": 0, "paged_attention_quant": 0,
                "paged_attention_multi_quant": 0}
        got = {k: d[k] for k in want}
        if got != want or d["replays"] != d["decode_steps"] \
                or d["admission_rejected"] or not d["dense_prefill_heads"]:
            raise RuntimeError(f"(e) launches {got} against {want}; "
                               f"counters {d}")
        log(f"  (e) launches: {got} = {cfg.n_layers} flash_fwd per dense "
            f"prefill head ({d['dense_prefill_heads']}) and embed "
            f"({d['embeds']}), {2 * cfg.n_layers + 1} rms_norm per each, "
            f"per dense chunk ({d['dense_prefill_chunks']}), decode step "
            f"({d['decode_steps']} replays) and paged chunk "
            f"({d['paged_prefill_chunks']})")
        out["launches"], out["counts"] = got, d
        with engine._prefix_lock:   # idle: every request done
            out["graphs"] = graph_checks(torch, engine, card,
                                         ENGINE_REL_L2_LIMIT, "7o engine")
        out["drain"] = http_and_drain(engine, prompt)
    finally:
        engine.stop()
    return out


def openai_chat_checks(torch, engine, cfg, params, port, tok, bias) -> dict:
    """(b) POST /v1/chat/completions with n = 2 (one member a slot): two
    choices from one prefill on the dense route, usage, a stop string
    cutting the text; a greedy choice against /generate of the same
    prompt; logprobs of /v1/completions finite and <= 0."""
    messages = [{"role": "system", "content": "You answer in vowels."},
                {"role": "user", "content": "Say a few vowels, please."}]
    chat_tokens = tok.apply_chat(messages)
    body = {"messages": messages, "n": 2, "max_tokens": 16,
            "temperature": 0, "logit_bias": bias}
    dense0 = engine.counters["dense_prefills"]
    first = http_ok(port, "/v1/chat/completions", body)
    texts = [c["message"]["content"] for c in first["choices"]]
    usage = first["usage"]
    if (engine.counters["dense_prefills"] != dense0 + 1 or len(texts) != 2
            or usage != {"prompt_tokens": len(chat_tokens),
                         "completion_tokens": 32,
                         "total_tokens": len(chat_tokens) + 32}
            or not all(len(t) == 16 for t in texts)):
        raise RuntimeError(f"(b) chat n=2: {first}")
    toks = [list(t.encode()) for t in texts]
    same = biased_divergence(torch, cfg, params, chat_tokens, toks[0],
                             toks[1], bias)
    gen = http_ok(port, "/generate", {"tokens": chat_tokens,
                                      "max_new_tokens": 16,
                                      "temperature": 0, "logit_bias": bias})
    vs_generate = biased_divergence(torch, cfg, params, chat_tokens, toks[0],
                                    gen["tokens"], bias)
    # the stop: the same request twice more (both gather the prompt's pages
    # the first inserted, so both take one path), the second with a stop
    again = http_ok(port, "/v1/chat/completions", body)
    text = again["choices"][0]["message"]["content"]
    stop = text[len(text) // 2]
    cut = http_ok(port, "/v1/chat/completions", dict(body, stop=stop))
    want = text[:text.index(stop)]
    if any(c["message"]["content"] != want or c["finish_reason"] != "stop"
           for c in cut["choices"]):
        raise RuntimeError(f"(b) stop {stop!r} on {text!r}: {cut}")
    comp = http_ok(port, "/v1/completions",
                   {"prompt": "Vowels:", "max_tokens": 16, "temperature": 0,
                    "logit_bias": bias, "logprobs": 1})
    lps = comp["choices"][0]["logprobs"]["token_logprobs"]
    if len(lps) != 16 or not all(math.isfinite(x) and x <= 0 for x in lps):
        raise RuntimeError(f"(b) logprobs {lps}")
    log(f"  (b) chat n=2 on the dense route: {texts[0]!r} / {texts[1]!r} "
        f"(choices {'equal' if same['diverge_at'] is None else 'part at a near-tie'}), "
        f"usage {usage}; vs /generate: "
        f"{'equal' if vs_generate['diverge_at'] is None else vs_generate}; "
        f"stop {stop!r} cut {text!r} to {want!r}; logprobs in "
        f"[{min(lps):.3f}, {max(lps):.3f}]")
    return {"texts": texts, "usage": usage, "choices_agree": same,
            "vs_generate": vs_generate, "stop": stop, "cut": want,
            "logprobs": lps}


def openai_stream_check(port, bias) -> dict:
    """(c) POST /v1/completions with stream: true: SSE chunks that
    concatenate to the non-streamed text and end in data: [DONE] (a
    one-token warm-up first caches the prompt's pages, so both measured
    requests gather them and take one path)."""
    base = {"prompt": "Stream some vowels and spaces, then stop:",
            "max_tokens": 16, "temperature": 0, "logit_bias": bias}
    http_ok(port, "/v1/completions", dict(base, max_tokens=1))
    flat = http_ok(port, "/v1/completions", base)["choices"][0]
    status, raw = http_post(port, "/v1/completions", dict(base, stream=True))
    frames = raw.decode().split("\n\n")
    if status != 200 or frames[-1] != "" or frames[-2] != "data: [DONE]" \
            or not all(f.startswith("data: ") for f in frames[:-1]):
        raise RuntimeError(f"(c) SSE framing: {status} {raw[:400]}")
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-2]]
    text = "".join(c["choices"][0]["text"] for c in chunks)
    reason = chunks[-1]["choices"][0]["finish_reason"]
    if text != flat["text"] or reason != flat["finish_reason"]:
        raise RuntimeError(f"(c) streamed {text!r} ({reason}) vs "
                           f"{flat['text']!r} ({flat['finish_reason']})")
    log(f"  (c) SSE: {len(chunks)} chunks, [DONE], text {text!r} equal to "
        f"the non-streamed completion")
    return {"chunks": len(chunks), "text": text}


def embeddings_check(torch, engine, cfg, params, port, prompt) -> dict:
    """(d) POST /v1/embeddings of a 1000-token input against the plain f32
    forward's mean-pooled final-norm hidden state, within the engine's
    limit; an input past max_prefill_len answers 400."""
    toks = prompt(1000)
    got = http_ok(port, "/v1/embeddings", {"input": toks})
    vec = torch.tensor(got["data"][0]["embedding"], device=engine.device)
    with engine._prefix_lock:
        ref = plain_logits(torch, cfg, params,
                           torch.tensor([toks], device=engine.device),
                           hidden=True)[0].mean(dim=0)
    rel = ((vec - ref).norm() / ref.norm()).item()
    status, _ = http_post(port, "/v1/embeddings",
                          {"input": prompt(engine.sc.max_prefill_len + 1)})
    if not rel <= ENGINE_REL_L2_LIMIT or status != 400 \
            or got["usage"]["prompt_tokens"] != 1000:
        raise RuntimeError(f"(d) embeddings: rel L2 {rel}, over-long input "
                           f"answered {status}, usage {got['usage']}")
    log(f"  (d) /v1/embeddings, 1000 tokens: relative L2 {rel:.4f} from the "
        f"plain f32 forward's pooled state (limit {ENGINE_REL_L2_LIMIT}); "
        f"{engine.sc.max_prefill_len + 1} tokens -> 400")
    return {"rel_l2": rel, "limit": ENGINE_REL_L2_LIMIT,
            "over_long_status": status}


def write_safetensors(path: str, tensors: dict) -> int:
    """A safetensors file (8-byte little-endian header length, the JSON
    header with each tensor's dtype, shape and data_offsets, padded to 8
    bytes, then the data); the machine with the card has no safetensors
    package. Returns the bytes written."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.int8: "I8"}
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        blobs.append(t)
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in blobs:
            f.write(t.view(torch.uint8).reshape(-1).numpy())
    return 8 + len(raw) + offset


def hf_load_phase(torch, dev, cfg, params) -> dict:
    """The llama3-8b widths at HF_LAYERS layers (the engine phase's first
    layers), exported by the port's ``to_hf_state_dict``, written as a
    2-shard safetensors directory with its index, loaded onto the card by
    ``load_hf``: every leaf must be bit-identical to the source."""
    from k8s_runpod_kubelet_tpu_torch.models import convert

    small = dataclasses.replace(cfg, n_layers=HF_LAYERS)
    src = {k: v for k, v in params.items() if k != "layers"}
    src["layers"] = {k: v[:HF_LAYERS] for k, v in params["layers"].items()}
    t0 = time.perf_counter()
    sd = convert.to_hf_state_dict(small, src)
    export_s = time.perf_counter() - t0
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        nbytes, weight_map = 0, {}
        for fname, keys in shards.items():
            nbytes += write_safetensors(os.path.join(d, fname),
                                        {k: sd[k] for k in keys})
            weight_map.update(dict.fromkeys(keys, fname))
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        write_s = time.perf_counter() - t0
        del sd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = convert.load_hf(small, d, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    bad = [k for k in src if k != "layers"
           if not (loaded[k].dtype == src[k].dtype
                   and torch.equal(loaded[k], src[k]))]
    bad += [f"layers/{k}" for k in src["layers"]
            if not (loaded["layers"][k].dtype == src["layers"][k].dtype
                    and torch.equal(loaded["layers"][k], src["layers"][k]))]
    if bad:
        raise RuntimeError(f"load_hf differs from the source in {bad}")
    log(f"  {HF_LAYERS} layers at llama3-8b widths: to_hf_state_dict "
        f"{export_s:.2f} s, 2 shards + index {nbytes / 2**30:.2f} GiB "
        f"written in {write_s:.2f} s, load_hf onto the card {load_s:.2f} s "
        f"({nbytes / load_s / 2**30:.2f} GiB/s); every leaf bit-identical")
    del loaded
    return {"layers": HF_LAYERS, "bytes": nbytes, "export_s": export_s,
            "write_s": write_s, "load_s": load_s, "bit_identical": True}


def quant_logits(torch, model, params, prompt, kv_int8=True,
                 adapters=None, adapter_id=0) -> "torch.Tensor":
    """Last-token logits of ``prompt`` prefilled in one chunk through the
    quantized engine's model and params, over a fresh int8 (or with
    ``kv_int8=False`` bf16) arena; with an engine's LoRA ``adapters``
    stacks, under its slot ``adapter_id``."""
    dev, t, n = model.device, 16, len(prompt)
    n_pages = -(-n // t)
    arena = model.init_paged_arena(n_pages, t, quantize=kv_int8)
    table = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    table[0, :n_pages] = torch.arange(n_pages, device=dev)
    ad = ({} if adapters is None else
          {"adapters": adapters, "adapter_ids": torch.tensor(
              [adapter_id], dtype=torch.int32, device=dev)})
    logits, _, _ = model.paged_prefill_chunk_step(
        params, torch.tensor([prompt], dtype=torch.int32, device=dev), arena,
        table, torch.zeros(1, dtype=torch.int32, device=dev),
        torch.tensor([n], dtype=torch.int32, device=dev), **ad)
    return logits[0]


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quant_engine_phase(torch, dev, card: str, cfg, params: list,
                       bf16: dict, bf16_logits) -> dict:
    """The memory-lean deployment: the engine built through the serve
    CLI's own arguments (``--int4 --kv-int8``, 8 slots, cache_len 2048)
    from the bf16 phase's seeded params, which it quantizes on the card;
    the caller's bf16 params are then dropped. The burst with exact
    launches per step (no bf16 paged kernel), memory, the independent check
    against a plain f32 forward of the dequantized weights over
    unquantized K/V, the gap to the bf16 engine's logits (information
    only), HTTP, drain. ``params`` is a one-element list holding the bf16
    tree, emptied once the engine holds its quantized copy. Returns the
    record, the engine's quantized tree and its one-chunk last-token logits
    of the checked prompt (phase 7t's one-device side)."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
         "--kv-int8"])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(args, params[0])
    params.clear()   # the caller's bf16 tree goes; the engine holds int4
    gc.collect()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    try:
        sc = engine.sc
        if not (sc.quantize_int4 and sc.quantize_kv_int8 and sc.slots == 8
                and sc.cache_len == 2048 and sc.max_prefill_len == 1024):
            raise RuntimeError(f"--int4 --kv-int8 built {sc}")
        p = engine.params
        weights = {
            "q4": sum(w["q4"].numel() for w in p["layers"].values()
                      if isinstance(w, dict)),
            "scales": sum(w["scale"].numel() * 4 for w in p["layers"].values()
                          if isinstance(w, dict)),
            "lm_head": tensor_bytes(p["lm_head"]),
            "tok_embed": tensor_bytes(p["tok_embed"]),
            "norms": tensor_bytes(p["final_norm"]) + sum(
                tensor_bytes(w) for n, w in p["layers"].items()
                if n.endswith("norm"))}
        arena = tensor_bytes(engine._kv_store.arena)
        snap = engine.debug_snapshot()
        log(f"  --int4 --kv-int8: weights {snap['weights']}, kv {snap['kv']}, "
            f"quantized on the card in {quant_s:.1f} s; weight bytes "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in weights.items())
            + f" ({sum(weights.values()) / 1e9:.3f} GB); arena "
            f"{engine._kv_store.pool.n_pages} pages of "
            f"{snap['prefix_cache']['page_bytes']} bytes, {arena / 1e9:.3f} "
            f"GB; [{card}] allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" GiB (bf16 params freed), peak while quantizing "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (from "
            f"{before / 2**30:.2f} GiB)")
        torch.cuda.reset_peak_memory_stats()
        per_step = {"paged_attention_multi_quant": cfg.n_layers,
                    "int4_matmul": 7 * cfg.n_layers + 1,
                    "rms_norm": 2 * cfg.n_layers + 1,
                    "paged_attention_multi": 0, "paged_attention": 0,
                    "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (paged_attention_multi_quant, int4_matmul,
                           rms_norm, paged_attention_multi, paged_attention,
                           paged_attention_quant), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        prompts = rec.pop("prompts")
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card,
                                         QUANT_ENGINE_REL_L2_LIMIT,
                                         "int4/int8 engine")
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2])
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=QUANT_ENGINE_REL_L2_LIMIT, what="int4/int8 engine")
        ref_bf16 = bf16_logits.to(logits.device)
        gap = {"rel_l2": ((logits - ref_bf16).norm()
                          / ref_bf16.norm()).item(),
               "argmax_agree": bool(logits.argmax() == ref_bf16.argmax()),
               "same_tokens": sum(a == b for x, y in zip(rec["tokens"],
                                                         bf16["tokens"])
                                  for a, b in zip(x, y))}
        log(f"  gap to the bf16 engine (information only): last-token "
            f"logits relative L2 {gap['rel_l2']:.4f}, argmax agree "
            f"{gap['argmax_agree']}; {gap['same_tokens']}/256 burst tokens "
            f"equal")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, gap_to_bf16=gap,
                   weight_bytes=weights, arena_bytes=arena,
                   page_bytes=snap["prefix_cache"]["page_bytes"],
                   quantize_s=quant_s, serve_peak_bytes=serve_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        return rec, engine.params, logits
    finally:
        engine.stop()


def shard_bytes(tree, source, n: int) -> int:
    """Bytes one shard of an in-process tensor mesh holds of ``tree``: the
    N-th of a split leaf (one axis more than its ``source`` leaf), a
    replicated leaf whole."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, source[k], n) for k, v in tree.items())
    nbytes = tree.numel() * tree.element_size()
    return nbytes // n if tree.dim() != source.dim() else nbytes


def tp_engine_phase(torch, dev, card: str, cfg, params, one_logits,
                    tensor: int, quant: bool) -> dict:
    """Phase 7t (b) and (c): the engine the serve CLI builds from
    ``--tensor-parallel N`` (with ``--int4 --kv-int8`` when ``quant``; 8
    slots, cache_len 2048) on an in-process tensor mesh, over ``params``,
    the one-device engine's tree (phase 7b's quantized tree, or phase 4's
    bf16 tree), which stays whole: the engine shards its own copy of the
    tree's dicts. The burst of phase 4 with exact launches per step (the
    paged kernel once a shard and layer; with int4 ``int4_matmul_sharded``
    once a projection and no ``int4_matmul``), memory (weights a shard,
    arena, peak), (g1)-(g5), the last-token logits of the checked prompt
    against ``one_logits`` (the one-device engine's, same weights) within
    ``TP_INT4_REL_L2_LIMIT`` or ``TP_BF16_REL_L2_LIMIT``, the independent
    check against the plain f32 forward of the same weights at the
    one-device engine's limit, HTTP, drain."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  int4_matmul_sharded,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", cfg.name, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32",
            "--tensor-parallel", str(tensor)]
    if quant:
        argv += ["--int4", "--kv-int8"]
    what = f"tensor {tensor} {'int4/int8' if quant else 'bf16'} engine"
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tree = {k: dict(v) if isinstance(v, dict) else v
            for k, v in params.items()}
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), tree)
    del tree
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    try:
        snap = engine.debug_snapshot()
        if snap["paged_tp_shards"] != tensor \
                or snap["kv_arena_shards"] != tensor \
                or engine.sc.quantize_int4 != quant:
            raise RuntimeError(f"{argv} built {engine.sc}, {snap}")
        weights = tensor_bytes(engine.params)
        per_shard = shard_bytes(engine.params, params, tensor)
        arena = tensor_bytes(engine._kv_store.arena)
        log(f"  {what} (--tensor-parallel {tensor} in one process): weights "
            f"{weights / 1e9:.3f} GB, {per_shard / 1e9:.3f} GB a shard; "
            f"arena {engine._kv_store.pool.n_pages} pages of "
            f"{snap['prefix_cache']['page_bytes']} bytes "
            f"({snap['prefix_cache']['page_bytes_per_shard']} a shard), "
            f"{arena / 1e9:.3f} GB; sharded in {shard_s:.1f} s; [{card}] "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"(the one-device tree kept), peak while sharding "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (from "
            f"{before / 2**30:.2f} GiB)")
        torch.cuda.reset_peak_memory_stats()
        attn = paged_attention_multi_quant if quant else paged_attention_multi
        other = paged_attention_multi if quant else \
            paged_attention_multi_quant
        per_step = {attn.__name__: tensor * cfg.n_layers,
                    "int4_matmul_sharded": (7 * cfg.n_layers + 1) if quant
                    else 0,
                    "int4_matmul": 0, "rms_norm": 2 * cfg.n_layers + 1,
                    other.__name__: 0, "paged_attention": 0,
                    "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (attn, int4_matmul_sharded, int4_matmul, rms_norm,
                           other, paged_attention, paged_attention_quant),
                          per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        prompts = rec.pop("prompts")
        limit = QUANT_ENGINE_REL_L2_LIMIT if quant else ENGINE_REL_L2_LIMIT
        tp_limit = TP_INT4_REL_L2_LIMIT if quant else TP_BF16_REL_L2_LIMIT
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card, limit, what)
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2], kv_int8=quant)
            reference = engine_reference_check(torch, cfg, params,
                                               prompts[2], logits,
                                               limit=limit, what=what)
        one = one_logits.to(logits.device)
        gap = {"rel_l2": ((logits - one).norm() / one.norm()).item(),
               "max_abs_diff": (logits - one).abs().max().item(),
               "identical": bool(torch.equal(logits, one)),
               "argmax_agree": bool(logits.argmax() == one.argmax()),
               "limit_rel_l2": tp_limit}
        log(f"  {what} vs the one-device engine on the same weights, "
            f"last-token logits of a {len(prompts[2])}-token chunk: "
            f"relative L2 {gap['rel_l2']:.4f} (limit {tp_limit}), max abs "
            f"{gap['max_abs_diff']:.4f}, identical {gap['identical']}, "
            f"argmax agree {gap['argmax_agree']}")
        if not gap["rel_l2"] <= tp_limit:
            raise RuntimeError(f"{what} off the one-device engine: {gap}")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, gap_to_one_device=gap,
                   weight_bytes=weights, weight_bytes_per_shard=per_shard,
                   arena_bytes=arena,
                   page_bytes=snap["prefix_cache"]["page_bytes"],
                   page_bytes_per_shard=snap["prefix_cache"]
                   ["page_bytes_per_shard"], shard_s=shard_s,
                   serve_peak_bytes=serve_peak)
        return rec
    finally:
        engine.stop()


def moe_engine_phase(torch, dev, card: str) -> dict:
    """Phase 7m: mixtral-8x7b at full width and depth, the engine the serve
    CLI builds from ``--model mixtral-8x7b --int4`` (8 slots, cache_len
    2048, 16-token pages, the bf16 arena, weights drawn from the seed and
    quantized a layer at a time: the bf16 tree, 93 GB, never exists).
    Weight and arena bytes and peak memory (under ``CARD_BYTES``); the
    burst with exact launches per step and chunk (``int4_expert_matmul``
    3 a layer, ``int4_matmul`` 4 a layer and the head, the bf16 paged
    kernel once a layer, ``rms_norm`` twice a layer and once, no other
    attention kernel); (g1)-(g5); the independent check against a plain
    f32 forward of the dequantized weights, one layer at a time; HTTP and
    drain. The engine and its weights are freed before it returns."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        int4_expert_matmul, int4_matmul, paged_attention,
        paged_attention_mla, paged_attention_mla_quant,
        paged_attention_multi, paged_attention_multi_mla,
        paged_attention_multi_mla_quant, paged_attention_multi_quant,
        paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", "mixtral-8x7b", "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
         "--seed", str(SEED)])
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    try:
        cfg, sc = engine.cfg, engine.sc
        if not (cfg.name == "mixtral-8x7b" and cfg.n_layers == 32
                and sc.quantize_int4 and not sc.quantize_kv_int8
                and sc.slots == 8 and sc.cache_len == 2048
                and sc.max_prefill_len == 1024):
            raise RuntimeError(f"--model mixtral-8x7b --int4 built {cfg}, "
                               f"{sc}")
        lp = engine.params["layers"]
        experts = ("we_gate", "we_up", "we_down")
        weights = {
            "expert_q4": sum(lp[n]["q4"].numel() for n in experts),
            "expert_scales": sum(lp[n]["scale"].numel() * 4
                                 for n in experts),
            "attention_q4_and_scales": sum(
                tensor_bytes(lp[n]) for n in ("wq", "wk", "wv", "wo")),
            "router": tensor_bytes(lp["router"]),
            "lm_head": tensor_bytes(engine.params["lm_head"]),
            "tok_embed": tensor_bytes(engine.params["tok_embed"]),
            "norms": tensor_bytes(engine.params["final_norm"]) + sum(
                tensor_bytes(w) for n, w in lp.items()
                if n.endswith("norm"))}
        arena = tensor_bytes(engine._kv_store.arena)
        snap = engine.debug_snapshot()
        log(f"  {cfg.name}: {cfg.n_layers} layers, E={cfg.embed_dim}, "
            f"{cfg.n_experts} experts of {cfg.mlp_dim} top-"
            f"{cfg.n_experts_per_tok}; weights {snap['weights']}, kv "
            f"{snap['kv']}, drawn and quantized on the card in "
            f"{build_s:.1f} s (graphs captured); weight bytes "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in weights.items())
            + f" ({sum(weights.values()) / 1e9:.3f} GB); arena "
            f"{engine._kv_store.pool.n_pages} pages of "
            f"{snap['prefix_cache']['page_bytes']} bytes, {arena / 1e9:.3f} "
            f"GB; [{card}] allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak while "
            f"building {build_peak / 2**30:.2f} GiB (from "
            f"{before / 2**30:.2f} GiB)")
        if not build_peak < CARD_BYTES:
            raise RuntimeError(f"peak {build_peak} B while building")
        torch.cuda.reset_peak_memory_stats()
        n = cfg.n_layers
        per_step = {"int4_expert_matmul": 3 * n, "int4_matmul": 4 * n + 1,
                    "paged_attention_multi": n, "rms_norm": 2 * n + 1,
                    "paged_attention_multi_quant": 0,
                    "paged_attention_multi_mla": 0,
                    "paged_attention_multi_mla_quant": 0,
                    "paged_attention": 0, "paged_attention_quant": 0,
                    "paged_attention_mla": 0, "paged_attention_mla_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (int4_expert_matmul, int4_matmul,
                           paged_attention_multi, rms_norm,
                           paged_attention_multi_quant,
                           paged_attention_multi_mla,
                           paged_attention_multi_mla_quant, paged_attention,
                           paged_attention_quant, paged_attention_mla,
                           paged_attention_mla_quant), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        prompts = rec.pop("prompts")
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card,
                                         MOE_ENGINE_REL_L2_LIMIT,
                                         "mixtral int4 engine")
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2], kv_int8=False)
            picks: list = []
            ref: list = []
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=MOE_ENGINE_REL_L2_LIMIT, what="mixtral int4 engine",
                gate=False, picks=picks, keep=ref)
            layers = moe_layer_check(torch, engine.model, engine.params,
                                     prompts[2], picks)
        check_peak = torch.cuda.max_memory_allocated()
        log(f"phase 7m (h): the same tree laid out over --tensor-parallel "
            f"{TP7M} --expert-parallel {EP7M} in one process")
        rec["ep_tp"] = moe_ep_tp_phase(torch, dev, card, engine,
                                       rec["tokens"], prompts, logits,
                                       ref[0], picks)
        del ref, picks
        if not max(serve_peak, check_peak) < CARD_BYTES:
            raise RuntimeError(f"peak {max(serve_peak, check_peak)} B")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, layer_check=layers,
                   weight_bytes=weights, arena_bytes=arena,
                   page_bytes=snap["prefix_cache"]["page_bytes"],
                   build_s=build_s, build_peak_bytes=build_peak,
                   serve_peak_bytes=serve_peak, check_peak_bytes=check_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def moe_ep_tp_phase(torch, dev, card: str, one, one_tokens, prompts,
                    one_logits, ref_logits, free_picks) -> dict:
    """Phase 7m (h): the one-device Mixtral engine's int4 tree (``one``,
    idle) laid out again over ``--tensor-parallel TP7M --expert-parallel
    EP7M`` in one process through the serve CLI: no second draw, the
    int4 experts held once (replicated over tensor; each expert shard the
    outer part of the expert axis), the attention and head split. 7m's
    burst with exact launches a step (row 8 once a shard and layer, row
    15 4 a layer and the head, row 14 3 a layer: one launch over every
    expert shard's experts, row 12 twice a layer and once); (g1)-(g5);
    7m's layer check on this engine (``moe_layer_check`` with the
    one-device tree as the references' weights and 7m's ``free_picks``):
    every layer's attention and MLP within MOE_LAYER_REL_L2_LIMIT of the
    plain f32 layer on the engine's own input, every routing choice that
    differs from the f32 router's a near tie; the control, wq's two
    tensor shards swapped in every layer (each shard's q heads then meet
    the other shard's kv heads and wo rows), must put an attention beyond
    the limit. In one process the expert split is the identity (the int4
    experts are neither moved nor split), so this phase holds the tensor
    split, the layout and the launches, not an exchange between expert
    shards (``tests/test_torch_expert_parallel.py`` holds the
    process-group form on gloo).
    Reported, as 7m reports its whole-model reading: the greedy tokens
    against the one-device engine's (``one_tokens``; a random Mixtral's
    routing flips at near ties and the 32 layers amplify them, so the
    one-device engine itself reads 0.5 off the f32 forward), the checked
    prompt's last-token logits against the one-device engine's
    (``one_logits``) and the plain f32 forward's (``ref_logits``); peak
    memory; HTTP and drain."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        int4_expert_matmul, int4_matmul, int4_matmul_sharded,
        paged_attention, paged_attention_multi, paged_attention_multi_quant,
        paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", one.cfg.name, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
            "--tensor-parallel", str(TP7M), "--expert-parallel", str(EP7M)]
    what = f"mixtral int4 EP {EP7M} x TP {TP7M} engine"
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tree = {k: dict(v) if isinstance(v, dict) else v
            for k, v in one.params.items()}
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), tree)
    del tree
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    try:
        cfg, snap = engine.cfg, engine.debug_snapshot()
        lp, one_lp = engine.params["layers"], one.params["layers"]
        experts = ("we_gate", "we_up", "we_down")
        if not (snap["tensor_parallel"] == TP7M
                and snap["expert_parallel"] == EP7M
                and snap["kv_arena_shards"] == TP7M
                and all(lp[n][k] is one_lp[n][k] for n in experts
                        for k in ("q4", "scale"))):
            raise RuntimeError(f"{argv} built {snap}, or moved the experts")
        added = torch.cuda.memory_allocated() - before
        log(f"  {what}: built in {shard_s:.1f} s over the one-device tree; "
            f"the experts held once ({tensor_bytes({n: lp[n] for n in experts}) / 1e9:.3f}"
            f" GB), {added / 1e9:.3f} GB added (split attention and head, "
            f"the arena, the graphs); [{card}] allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with both "
            f"engines")
        torch.cuda.reset_peak_memory_stats()
        n = cfg.n_layers
        per_step = {"int4_expert_matmul": 3 * n,
                    "int4_matmul_sharded": 4 * n + 1,
                    "paged_attention_multi": TP7M * n, "rms_norm": 2 * n + 1,
                    "int4_matmul": 0, "paged_attention_multi_quant": 0,
                    "paged_attention": 0, "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (int4_expert_matmul, int4_matmul_sharded,
                           paged_attention_multi, rms_norm, int4_matmul,
                           paged_attention_multi_quant, paged_attention,
                           paged_attention_quant), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB (both engines held)")
        prompts = rec.pop("prompts")

        same = [a == b for a, b in zip(rec["tokens"], one_tokens)]
        first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None) for a, b in zip(rec["tokens"], one_tokens)]
        with one._prefix_lock, engine._prefix_lock:   # both idle
            rec["graphs"] = graph_checks(torch, engine, card,
                                         MOE_ENGINE_REL_L2_LIMIT, what)
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2], kv_int8=False)
            layers = moe_layer_check(torch, engine.model, engine.params,
                                     prompts[2], free_picks,
                                     ref_params=one.params)
            # the control: wq's tensor shards (axis 1 of its q4 and
            # scale) rolled by one in every layer, in a copy of wq
            swapped = dict(engine.params, layers=dict(lp, wq={
                k: t.roll(1, 1) for k, t in lp["wq"].items()}))
            control = moe_layer_check(torch, engine.model, swapped,
                                      prompts[2], free_picks,
                                      ref_params=one.params, gate=False)
            del swapped
            gc.collect()
            torch.cuda.empty_cache()
        ref = ref_logits.to(logits.device)

        def rel(a, b) -> float:
            return ((a.float() - b.float()).norm() / b.float().norm()).item()

        gap = {"rel_l2_to_one_device": rel(logits, one_logits),
               "argmax_agree": bool(logits.argmax() == one_logits.argmax()),
               "plain_f32_rel_l2": rel(logits, ref),
               "one_device_plain_f32_rel_l2": rel(one_logits, ref),
               "requests_equal": sum(same), "first_divergence": first,
               "control_wq_shards_swapped_worst_attn_rel_l2":
                   control["worst"]["attn_rel_l2"]}
        log(f"  {what}: greedy tokens equal to the one-device engine's in "
            f"{sum(same)}/{len(same)} requests (first divergence at "
            f"{first}); last-token logits of a {len(prompts[2])}-token "
            f"chunk {gap['rel_l2_to_one_device']:.4f} off the one-device "
            f"engine's, {gap['plain_f32_rel_l2']:.4f} off the plain f32 "
            f"forward (the one-device engine "
            f"{gap['one_device_plain_f32_rel_l2']:.4f}); reported, not "
            f"gated. Control, wq's tensor shards swapped: worst attention "
            f"{gap['control_wq_shards_swapped_worst_attn_rel_l2']:.3f} "
            f"(limit {MOE_LAYER_REL_L2_LIMIT})")
        if not gap["control_wq_shards_swapped_worst_attn_rel_l2"] \
                > MOE_LAYER_REL_L2_LIMIT:
            raise RuntimeError(f"wq's swapped tensor shards passed: {gap}")
        check_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated over the checks "
            f"{check_peak / 2**30:.2f} GiB (both engines and the swapped "
            "copy of wq)")
        if not max(serve_peak, check_peak) < CARD_BYTES:
            raise RuntimeError(f"{what}: peak {max(serve_peak, check_peak)}")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   layer_check=layers, gap_to_one_device=gap, shard_s=shard_s,
                   added_bytes=added, serve_peak_bytes=serve_peak,
                   check_peak_bytes=check_peak)
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def draw_deepseek_norms(torch, params, seed: int) -> None:
    """In place, every norm weight of a DeepSeek tree (both stacks' and the
    final one) drawn at U(DS_NORM_LOW, DS_NORM_LOW + 0.5), away from the
    JAX init's identity; the same numbers for the bf16 tree and the int4
    one (norms stay f32 in both)."""
    dev = params["tok_embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = [params["final_norm"]] + [
        w for stack in ("prefix_layers", "layers")
        for n, w in sorted(params[stack].items()) if n.endswith("norm")]
    for t in leaves:
        t.uniform_(DS_NORM_LOW, DS_NORM_LOW + 0.5, generator=gen)


def deepseek_weight_bytes(params) -> dict:
    """A DeepSeek tree's bytes by part."""
    lp, pp = params["layers"], params["prefix_layers"]
    attn = ("wq", "w_dkv", "w_uk", "w_uv", "wo")
    return {
        "routed_experts": sum(tensor_bytes(lp[n])
                              for n in ("we_gate", "we_up", "we_down")),
        "shared_experts": sum(tensor_bytes(lp[n])
                              for n in ("ws_gate", "ws_up", "ws_down")),
        "prefix_mlp": sum(tensor_bytes(pp[n])
                          for n in ("w_gate", "w_up", "w_down")),
        "attention": sum(tensor_bytes(s[n]) for s in (lp, pp)
                         for n in attn),
        "router": tensor_bytes(lp["router"]),
        "tok_embed": tensor_bytes(params["tok_embed"]),
        "lm_head": tensor_bytes(params["lm_head"]),
        "norms": tensor_bytes(params["final_norm"]) + sum(
            tensor_bytes(w) for s in (lp, pp) for n, w in s.items()
            if n.endswith("norm"))}


def deepseek_engine_run(torch, dev, card: str, cfg, params, quant: bool,
                        greedy_prompt=None) -> dict:
    """(a) bf16 or (b) ``--int4 --kv-int8``: the engine the serve CLI
    builds from ``--model deepseek-v2-lite`` (8 slots, cache_len 2048,
    16-token pages) over ``params`` (a one-element list, emptied once the
    engine holds the tree). Weight, arena and page bytes and peak memory
    (under ``CARD_BYTES``); the burst with exact launches per step and
    chunk (row 10, or 11 under int8, 27 a step; ``rms_norm`` 3 a layer and
    once; under int4 row 14 3 a routed layer and row 13 6 a layer and the
    head; every other kernel 0); (g1)-(g5); the last-token check against
    the plain f32 forward (reported) and the layer check (gated); with
    ``greedy_prompt`` its greedy tokens for (c); HTTP and drain."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        flash_fwd, int4_expert_matmul, int4_matmul, paged_attention,
        paged_attention_mla, paged_attention_mla_quant, paged_attention_multi,
        paged_attention_multi_mla, paged_attention_multi_mla_quant,
        paged_attention_multi_quant, paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", DS_MODEL, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32", "--seed",
            str(SEED)] + (["--int4", "--kv-int8"] if quant else [])
    what = f"{DS_MODEL} {'--int4 --kv-int8' if quant else 'bf16'} engine"
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv),
                                        params[0])
    params.clear()   # the engine holds the last reference
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    try:
        sc, store = engine.sc, engine._kv_store
        snap = engine.debug_snapshot()
        if not (engine.cfg == cfg and sc.slots == 8
                and sc.cache_len == 2048 and sc.kv_page_tokens == 16
                and sc.quantize_int4 == quant
                and sc.quantize_kv_int8 == quant
                and snap["kv_layout"] == "latent" and snap["paged_decode"]):
            raise RuntimeError(f"{what}: the CLI built {sc}, {snap}")
        sections = {n: tuple(a.shape) for n, a in store.arena.items()}
        if store.page_bytes != DS_PAGE_BYTES[quant] \
                or sections["c_pre"][0] != 1 or sections["c"][0] != 26:
            raise RuntimeError(f"{what}: arena {sections}, page "
                               f"{store.page_bytes} B, not "
                               f"{DS_PAGE_BYTES[quant]}")
        weights = deepseek_weight_bytes(engine.params)
        arena = tensor_bytes(store.arena)
        log(f"  {what}: {cfg.n_layers} layers ({cfg.n_dense_prefix} dense at "
            f"{cfg.dense_prefix_mlp_dim}), E={cfg.embed_dim}, "
            f"{cfg.n_experts} experts top-{cfg.n_experts_per_tok} and "
            f"{cfg.n_shared_experts} shared of {cfg.mlp_dim}; weights "
            f"{snap['weights']}, kv {snap['kv']}, built in {build_s:.1f} s "
            "(graphs captured); weight bytes "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in weights.items())
            + f" ({sum(weights.values()) / 1e9:.3f} GB); arena "
            f"{store.pool.n_pages} + 1 pages of {store.page_bytes} B "
            f"(sections {sections}), {arena / 1e9:.3f} GB; [{card}] "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
            f"peak while building {build_peak / 2**30:.2f} GiB (from "
            f"{before / 2**30:.2f} GiB)")
        if not build_peak < CARD_BYTES:
            raise RuntimeError(f"{what}: peak {build_peak} B while building")
        torch.cuda.reset_peak_memory_stats()
        n = cfg.n_layers
        routed = n - cfg.n_dense_prefix
        main = paged_attention_multi_mla_quant if quant \
            else paged_attention_multi_mla
        held = [k for k in (paged_attention_multi_mla,
                            paged_attention_multi_mla_quant,
                            paged_attention_mla, paged_attention_mla_quant,
                            paged_attention_multi,
                            paged_attention_multi_quant, paged_attention,
                            paged_attention_quant, flash_fwd)
                if k is not main]
        per_step = {main.__name__: n, "rms_norm": 3 * n + 1,
                    # wq, w_dkv, wo and the three MLP products (the shared
                    # experts', or the prefix's dense MLP) a layer, the head
                    "int4_matmul": 6 * n + 1 if quant else 0,
                    "int4_expert_matmul": 3 * routed if quant else 0,
                    **{k.__name__: 0 for k in held}}
        rec = serve_burst(torch, engine, cfg, card,
                          (main, rms_norm, int4_matmul, int4_expert_matmul,
                           *held), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        prompts = rec.pop("prompts")
        limit = MLA_INT8_ENGINE_REL_L2_LIMIT if quant \
            else MLA_ENGINE_REL_L2_LIMIT
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card, limit, what)
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2], kv_int8=quant)
            picks: list = []
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=MOE_ENGINE_REL_L2_LIMIT, what=what, gate=False,
                picks=picks)
            layers = moe_layer_check(torch, engine.model, engine.params,
                                     prompts[2], picks, kv_int8=quant)
            del picks
        check_peak = torch.cuda.max_memory_allocated()
        if not max(serve_peak, check_peak) < CARD_BYTES:
            raise RuntimeError(f"{what}: peak {max(serve_peak, check_peak)}")
        if greedy_prompt is not None:
            rec["greedy"] = engine.submit(
                greedy_prompt, max_new_tokens=DS_GREEDY_TOKENS).result(
                    timeout=900)["tokens"]
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, layer_check=layers,
                   weight_bytes=weights, arena_bytes=arena,
                   page_bytes=store.page_bytes, arena_sections=sections,
                   build_s=build_s, build_peak_bytes=build_peak,
                   serve_peak_bytes=serve_peak, check_peak_bytes=check_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        rec["tree"] = engine.params
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def deepseek_dense_and_contiguous(torch, dev, card: str, cfg, params,
                                  greedy_prompt, paged_tokens) -> dict:
    """(c) over the bf16 tree: (c1) the dense-scratch route on an engine of
    2 slots with the pool at its minimum (``dense_route_forced``: a
    1500-token prompt prefilled through MLA's direct form, the flash
    kernel at D = 192; its logits against the plain f32 forward,
    reported), then ``embed`` of 1000 tokens against the plain forward's
    pooled state (gated at ``MOE_ENGINE_REL_L2_LIMIT``); the counts set to
    0 before and read after: ``flash_fwd`` exactly 27 a dense prefill head
    and embed, no backward kernel, the latent kernel 27 a paged step, every
    other attention kernel 0; HTTP and drain. (c2) ``--prefix-cache off``:
    the engine the CLI builds serves from the contiguous loop, and its
    greedy tokens on ``greedy_prompt`` equal the paged loop's
    (``paged_tokens``), or where they first differ the plain f32 forward's
    top-2 margin is under ``SPEC_TIE_MARGIN`` of its logits' RMS."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.ops import (
        flash_dkv, flash_dq, flash_fwd, paged_attention_multi,
        paged_attention_multi_mla, paged_attention_multi_mla_quant,
        paged_attention_multi_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    n = cfg.n_layers
    sc = ServingConfig(slots=2, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, kv_pool_pages=256,
                       max_new_tokens=16)
    engine = ServingEngine(cfg, params, sc, device=dev).start()
    rng = np.random.default_rng(SEED + 23)

    def prompt(k: int) -> list[int]:
        return [int(x) for x in rng.integers(0, cfg.vocab_size, k)]

    held = (flash_dq, flash_dkv, paged_attention_multi_mla_quant,
            paged_attention_multi, paged_attention_multi_quant)
    kernels = (flash_fwd, rms_norm, paged_attention_multi_mla, *held)
    keys = ("decode_steps", "paged_prefill_chunks", "dense_prefills",
            "dense_prefill_heads", "dense_prefill_chunks", "embeds")

    def snap() -> dict:
        with engine._prefix_lock:
            return {**{k: engine.counters[k] for k in keys},
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    out = {}
    try:
        engine.submit(prompt(64), max_new_tokens=4).result(timeout=900)
        with engine._prefix_lock:
            for k in kernels:
                k.launches = 0
        s0 = snap()
        out["dense_route"] = dense_route_forced(
            torch, engine, cfg, params, prompt,
            limit=MOE_ENGINE_REL_L2_LIMIT, gate=False)
        etoks = prompt(1000)
        t0 = time.perf_counter()
        vec = torch.tensor(engine.embed(etoks), device=dev)
        embed_ms = (time.perf_counter() - t0) * 1e3
        s1 = snap()
        with engine._prefix_lock:
            ref = plain_logits(torch, cfg, params,
                               torch.tensor([etoks], device=dev),
                               hidden=True)[0].mean(dim=0)
        rel = ((vec - ref).norm() / ref.norm()).item()
        out["embed"] = {"rel_l2": rel, "limit": MOE_ENGINE_REL_L2_LIMIT,
                        "embed_ms": embed_ms}
        log(f"  (c) embed of 1000 tokens in {embed_ms:.1f} ms: relative L2 "
            f"{rel:.4f} from the plain f32 forward's pooled state (limit "
            f"{MOE_ENGINE_REL_L2_LIMIT})")
        if not rel <= MOE_ENGINE_REL_L2_LIMIT:
            raise RuntimeError(f"(c) embed off the plain forward: {rel}")
        d = {k: s1[k] - s0[k] for k in s0}
        heads = d["dense_prefill_heads"] + d["embeds"]
        steps = d["decode_steps"] + d["paged_prefill_chunks"]
        want = {"flash_fwd": n * heads,
                "rms_norm": (3 * n + 1)
                * (steps + heads + d["dense_prefill_chunks"]),
                "paged_attention_multi_mla": n * steps,
                **{k.__name__: 0 for k in held}}
        got = {k: d[k] for k in want}
        if got != want or d["replays"] != d["decode_steps"] \
                or d["dense_prefills"] < 1 or d["embeds"] != 1:
            raise RuntimeError(f"(c) dense route: launches {got} against "
                               f"{want}; counters {d}")
        log(f"  (c) launches: flash_fwd {got['flash_fwd']} (D = 192, 16 "
            f"heads) = {n} per dense prefill head "
            f"({d['dense_prefill_heads']}) and embed ({d['embeds']}); "
            f"rms_norm {got['rms_norm']}, paged_attention_multi_mla "
            f"{got['paged_attention_multi_mla']} over {d['decode_steps']} "
            f"replays and {d['paged_prefill_chunks']} paged chunks; flash "
            "backward and every other attention kernel 0")
        out["launches"], out["counts"] = got, d
        out["drain"] = http_and_drain(engine, prompt)
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    argv = ["--model", DS_MODEL, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32",
            "--prefix-cache", "off"]
    with_counts = (flash_fwd, paged_attention_multi_mla, rms_norm)
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), params)
    try:
        snap_c = engine.debug_snapshot()
        if snap_c["paged_decode"] or snap_c["cache_layout"] != "linear" \
                or not {"c_pre", "kr_pre"} <= set(engine._cache):
            raise RuntimeError(f"(c) --prefix-cache off built {snap_c}")
        c0 = {k.__name__: k.launches for k in with_counts}
        t0 = time.perf_counter()
        toks = engine.submit(greedy_prompt, max_new_tokens=DS_GREEDY_TOKENS
                             ).result(timeout=900)["tokens"]
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches - c0[k.__name__]
                  for k in with_counts}
        if counts["paged_attention_multi_mla"] or counts["flash_fwd"] < n:
            raise RuntimeError(f"(c) the contiguous loop launched {counts}")
        with engine._prefix_lock:
            div = divergence_check(torch, cfg, params, [greedy_prompt],
                                   [toks], [paged_tokens])
        same = sum(a == b for a, b in zip(toks, paged_tokens))
        log(f"  (c) --prefix-cache off (contiguous loop, linear cache with "
            f"c_pre/kr_pre): {len(toks)} greedy tokens of a "
            f"{len(greedy_prompt)}-token prompt in {wall:.2f} s, {same}/"
            f"{len(toks)} equal to the paged loop's; divergences "
            f"{div['divergences']} (tie margin {SPEC_TIE_MARGIN}); launches "
            f"{counts}")
        out["contiguous"] = {"tokens": toks, "paged_tokens": paged_tokens,
                             "same": same, "divergence": div,
                             "launches": counts, "wall_s": wall}
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def deepseek_profile(torch, card: str) -> dict:
    """(d) ``step_profile --model deepseek-v2-lite`` in bf16: the decode
    step eagerly and as a replay, a 1024-token chunk, and a training step
    at 4 layers, device ms by family (the bf16 expert products, forward
    and backward, their own ``experts`` family). The ``--int4`` profile
    (PERF.md section 5) stays one ``step_profile --model
    deepseek-v2-lite --int4`` away: its ~95 s went to the phases added
    with the expert mesh, the cost meter and ``--profile-dir``."""
    import tempfile

    from k8s_runpod_kubelet_tpu_torch.workloads import step_profile

    out = {}
    for label, extra in (("bf16", []),):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "profile.json")
            step_profile.main(["--model", DS_MODEL, "--out", path] + extra)
            with open(path) as f:
                prof = json.load(f)
        gc.collect()
        torch.cuda.empty_cache()

        def fams(p):
            by = p["device_ms_by_family"]
            return by if isinstance(by, str) else {
                k: round(v, 3) for k, v in sorted(by.items(),
                                                  key=lambda kv: -kv[1])}

        def ms(p):
            v = p["device_ms"]
            return v if isinstance(v, str) else round(v, 3)

        rec = {"decode_eager": {"device_ms": ms(prof["decode"]),
                                "by_family": fams(prof["decode"]),
                                "wall_ms": prof["decode"]["wall_ms"]},
               "decode_graph": {"device_ms": ms(prof["decode_graph"]["graph"]),
                                "by_family": fams(
                                    prof["decode_graph"]["graph"]),
                                "wall_ms":
                                    prof["decode_graph"]["graph"]["wall_ms"]},
               "chunk_1024": {"device_ms": ms(prof["prefill"]),
                              "by_family": fams(prof["prefill"]),
                              "wall_ms": prof["prefill"]["wall_ms"]}}
        if "train" in prof:
            rec["train_4_layers"] = {"device_ms": ms(prof["train"]),
                                     "by_family": fams(prof["train"]),
                                     "wall_ms": prof["train"]["wall_ms"]}
        out[label] = rec
        for step, r in rec.items():
            log(f"  (d) [{card}] {DS_MODEL} {label} {step}: device "
                f"{r['device_ms']} ms, wall {r['wall_ms']:.3f} ms; by "
                f"family {r['by_family']}")
    return out


def deepseek_phase(torch, dev, card: str) -> dict:
    """Phase 7v: DeepSeek-V2-Lite at full width and depth on one card,
    weights random from the seed with the norms drawn away from identity:
    (a) bf16 on the paged loop, (c) the dense route, embed and the
    contiguous loop over the same tree, (b) ``--int4 --kv-int8`` from a
    tree drawn and quantized a layer at a time, (d) the profile."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS, init_params
    from k8s_runpod_kubelet_tpu_torch.models.quant import \
        init_quantized_params

    cfg = MODEL_CONFIGS[DS_MODEL]()
    t0 = time.perf_counter()
    box = [init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)]
    draw_deepseek_norms(torch, box[0], SEED + 41)
    torch.cuda.synchronize()
    log(f"  random bf16 init of {cfg.param_count / 1e9:.3f} B parameters in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 29)
    greedy_prompt = [int(x) for x in rng.integers(0, cfg.vocab_size, 300)]
    out = {"param_count": cfg.param_count}
    out["bf16"] = deepseek_engine_run(torch, dev, card, cfg, box, False,
                                      greedy_prompt)
    tree = out["bf16"].pop("tree")
    log(f"  (c) {DS_MODEL} bf16: the dense-scratch route (2 slots, "
        "kv_pool_pages 256), embed, --prefix-cache off")
    out["dense_and_contiguous"] = deepseek_dense_and_contiguous(
        torch, dev, card, cfg, tree, greedy_prompt, out["bf16"]["greedy"])
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (b) {DS_MODEL} --int4 --kv-int8 (drawn and quantized a layer at "
        "a time from the same seed, the same norms)")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    box = [init_quantized_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(SEED), 4, dev)]
    draw_deepseek_norms(torch, box[0], SEED + 41)
    torch.cuda.synchronize()
    log(f"  int4 draw in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out["int4_kv_int8"] = deepseek_engine_run(torch, dev, card, cfg, box,
                                              True)
    tree = out["int4_kv_int8"].pop("tree")
    log(f"  (f) {DS_MODEL} --int4 --kv-int8 --expert-parallel {EP7V} in one "
        "process, over (b)'s tree, on (b)'s burst")
    out["ep"] = deepseek_ep_run(torch, dev, card, cfg, tree,
                                out["int4_kv_int8"])
    log(f"  (e) of phase 7k: {DS_MODEL} --int4 --kv-int8 through the wire "
        "rung (prefill, decode and unified engines on this tree)")
    out["handoff"] = deepseek_handoff(torch, dev, tree, greedy_prompt)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (d) step_profile --model {DS_MODEL} (bf16)")
    out["profile"] = deepseek_profile(torch, card)
    return out


def deepseek_ep_run(torch, dev, card: str, cfg, tree, one: dict) -> dict:
    """Phase 7v (f): (b)'s quantized tree served again through the serve
    CLI with ``--expert-parallel EP7V`` (tensor 1: each expert shard the
    outer part of the expert axis, every expert held once, no weight
    moved), on (b)'s burst: (b)'s launches a step (row 14 one launch over
    every shard's experts); its greedy tokens against (b)'s (``one``),
    each first divergence with this engine's own top-2 margin there as a
    share of its logits' RMS (reported: the decode batches' composition
    moves bf16 rounding, which a random MoE's routing can amplify); HTTP
    and drain with zero leaked pages."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        flash_fwd, int4_expert_matmul, int4_matmul, paged_attention,
        paged_attention_mla, paged_attention_mla_quant, paged_attention_multi,
        paged_attention_multi_mla, paged_attention_multi_mla_quant,
        paged_attention_multi_quant, paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", DS_MODEL, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
            "--kv-int8", "--expert-parallel", str(EP7V)]
    what = f"{DS_MODEL} --int4 --kv-int8 --expert-parallel {EP7V} engine"
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(
        serve_main.parse_args(argv),
        {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        snap = engine.debug_snapshot()
        lp = engine.params["layers"]
        if not (snap["expert_parallel"] == EP7V
                and snap["tensor_parallel"] == 1
                and all(lp[n][k] is tree["layers"][n][k]
                        for n in ("we_gate", "we_up", "we_down")
                        for k in ("q4", "scale"))):
            raise RuntimeError(f"{what}: built {snap}, or moved the experts")
        kernels = (paged_attention_multi_mla_quant, rms_norm, int4_matmul,
                   int4_expert_matmul, paged_attention_multi_mla,
                   paged_attention_mla, paged_attention_mla_quant,
                   paged_attention_multi, paged_attention_multi_quant,
                   paged_attention, paged_attention_quant, flash_fwd)
        rec = serve_burst(torch, engine, cfg, card, kernels,
                          one["launches_per_step"])
        prompts = rec.pop("prompts")

        div = []
        with engine._prefix_lock:   # idle
            for prompt, a, b in zip(prompts, rec["tokens"], one["tokens"]):
                n = next((i for i, (x, y) in enumerate(zip(a, b))
                          if x != y), None)
                if n is None:
                    continue
                own = quant_logits(torch, engine.model, engine.params,
                                   prompt + b[:n], kv_int8=True).float()
                top2 = own.topk(2).values
                div.append({"at": n, "margin_share": (
                    (top2[0] - top2[1]) / own.pow(2).mean().sqrt()).item()})
        log(f"  {what}: built in {build_s:.1f} s over (b)'s tree (experts "
            f"held once); greedy tokens against (b)'s: "
            f"{len(prompts) - len(div)}/{len(prompts)} requests equal; "
            f"divergences (position, this engine's top-2 margin share) "
            f"{[(d['at'], round(d['margin_share'], 4)) for d in div]}")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   divergence=div, build_s=build_s)
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def deepseek_handoff(torch, dev, tree, prompt) -> dict:
    """Phase 7k (e) for DeepSeek-V2-Lite ``--int4 --kv-int8``: the serve
    CLI's engines (2 slots) on 7v (b)'s quantized tree, through
    ``layout_wire_run``: the latent sections and the dense prefix's
    ``c_pre``/``kr_pre`` with their scales over the wire."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_expert_matmul,
                                                  int4_matmul,
                                                  paged_attention_multi_mla_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", DS_MODEL, "--device", dev.type, "--slots",
            str(DISAGG_SLOTS), "--cache-len", "2048", "--max-new-tokens",
            str(DISAGG_NEW), "--seed", str(SEED), "--int4", "--kv-int8"]
    engines = [serve_main.build_engine(serve_main.parse_args(argv), tree)[0]
               for _ in range(3)]
    return layout_wire_run(torch, engines, prompt,
                           (paged_attention_multi_mla_quant, int4_matmul,
                            int4_expert_matmul, rms_norm),
                           f"(7k e) {DS_MODEL} --int4 --kv-int8")


def mla_dense_route_phase(torch, dev, card: str, cfg, params,
                          kv_int8: bool) -> dict:
    """7c / 7d (e): mla-8b's dense-scratch route, whose prefill runs MLA's
    direct form through the flash kernels at D = 192, on an engine of 2
    slots, cache_len 2048 and the pool at its minimum (2 x 128 pages), over
    ``params`` (the phase's seeded bf16 tree) and bf16 or int8 latents:
    (a) a 1500-token prompt onto a pool that two 2040-token runs hold
    (``dense_route_forced``: the route taken once, all three finish, its
    logits against the plain f32 direct-form forward); (b) an n = 2 greedy
    group (one prefill on the dense route, the members' tokens equal); (c)
    ``embed`` of 1000 tokens against the plain f32 forward's mean-pooled
    final-norm state. The launch counts are set to 0 just before (a) and
    read after (c): ``flash_fwd`` exactly 32 per dense prefill head and per
    embed, no ``flash_dq``/``flash_dkv``, ``rms_norm`` 97 per head, embed,
    dense chunk, decode step and paged chunk, the latent kernel 32 per step
    and paged chunk, every other attention kernel 0, replays equal to decode
    steps; then (g1)-(g5) on its graphs, HTTP and drain with 0 leaked
    pages."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.ops import (
        flash_dkv, flash_dq, flash_fwd, paged_attention, paged_attention_mla,
        paged_attention_mla_quant, paged_attention_multi,
        paged_attention_multi_mla, paged_attention_multi_mla_quant,
        paged_attention_multi_quant, paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)

    limit = MLA_INT8_ENGINE_REL_L2_LIMIT if kv_int8 \
        else MLA_ENGINE_REL_L2_LIMIT
    what = f"{cfg.name}{' --kv-int8' if kv_int8 else ''} dense route"
    sc = ServingConfig(slots=2, cache_len=2048, max_prefill_len=1024,
                       kv_page_tokens=16, kv_pool_pages=256,
                       max_new_tokens=16, quantize_kv_int8=kv_int8)
    engine = ServingEngine(cfg, params, sc, device=dev).start()
    rng = np.random.default_rng(SEED + 16 + int(kv_int8))

    def prompt(n: int) -> list[int]:
        return [int(x) for x in rng.integers(0, cfg.vocab_size, n)]

    main = paged_attention_multi_mla_quant if kv_int8 \
        else paged_attention_multi_mla
    held = [k for k in (paged_attention_multi_mla,
                        paged_attention_multi_mla_quant, paged_attention_mla,
                        paged_attention_mla_quant, paged_attention_multi,
                        paged_attention_multi_quant, paged_attention,
                        paged_attention_quant) if k is not main]
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm, main, *held)
    keys = ("decode_steps", "paged_prefill_chunks", "dense_prefills",
            "dense_prefill_heads", "dense_prefill_chunks", "embeds",
            "admission_rejected")

    def snap() -> dict:
        with engine._prefix_lock:
            return {**{k: engine.counters[k] for k in keys},
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    out = {"kv_int8": kv_int8}
    try:
        engine.submit(prompt(64), max_new_tokens=4).result(timeout=900)
        # the main path: counts set to 0 just before it, read just after
        with engine._prefix_lock:
            for k in kernels:
                k.launches = 0
        s0 = snap()
        out["a"] = dense_route_forced(torch, engine, cfg, params, prompt)
        group = [f.result(timeout=900) for f in engine.submit_group(
            prompt(300), 2, max_new_tokens=8)]
        toks = [r["tokens"] for r in group]
        if toks[0] != toks[1] or len(toks[0]) != 8:
            raise RuntimeError(f"(b) the n = 2 greedy group gave {toks}")
        out["b"] = {"tokens": toks[0], "ttft_ms": [r["ttft_s"] * 1e3
                                                   for r in group]}
        log(f"  (b) n = 2 group, 300-token prompt: both members "
            f"{len(toks[0])} equal greedy tokens, TTFT "
            f"{out['b']['ttft_ms'][0]:.1f} ms")
        etoks = prompt(1000)
        t0 = time.perf_counter()
        vec = torch.tensor(engine.embed(etoks), device=dev)
        embed_ms = (time.perf_counter() - t0) * 1e3
        with engine._prefix_lock:
            ref = plain_logits(torch, cfg, params,
                               torch.tensor([etoks], device=dev),
                               hidden=True)[0].mean(dim=0)
        rel = ((vec - ref).norm() / ref.norm()).item()
        if not rel <= limit:
            raise RuntimeError(f"(c) embed: relative L2 {rel} from the plain "
                               f"f32 forward's pooled state (limit {limit})")
        out["c"] = {"rel_l2": rel, "limit": limit, "embed_ms": embed_ms}
        log(f"  (c) embed of 1000 tokens in {embed_ms:.1f} ms: relative L2 "
            f"{rel:.4f} from the plain f32 forward's pooled state (limit "
            f"{limit})")
        s1 = snap()
        d = {k: s1[k] - s0[k] for k in s0}
        heads = d["dense_prefill_heads"] + d["embeds"]
        steps = d["decode_steps"] + d["paged_prefill_chunks"]
        want = {"flash_fwd": cfg.n_layers * heads, "flash_dq": 0,
                "flash_dkv": 0,
                "rms_norm": (3 * cfg.n_layers + 1)
                * (steps + heads + d["dense_prefill_chunks"]),
                main.__name__: cfg.n_layers * steps,
                **{k.__name__: 0 for k in held}}
        got = {k: d[k] for k in want}
        if got != want or d["replays"] != d["decode_steps"] \
                or d["admission_rejected"] or d["dense_prefills"] < 2 \
                or not d["embeds"]:
            raise RuntimeError(f"{what}: launches {got} against {want}; "
                               f"counters {d}")
        log(f"  (e) launches: flash_fwd {got['flash_fwd']} (D = 192) = "
            f"{cfg.n_layers} per dense prefill head "
            f"({d['dense_prefill_heads']}) and embed ({d['embeds']}); "
            f"rms_norm {got['rms_norm']}, {main.__name__} "
            f"{got[main.__name__]} over {d['decode_steps']} replays, "
            f"{d['paged_prefill_chunks']} paged and "
            f"{d['dense_prefill_chunks']} "
            "dense chunks; every other kernel 0")
        out["launches"], out["counts"] = got, d
        with engine._prefix_lock:   # idle: every request done
            out["graphs"] = graph_checks(torch, engine, card, limit, what)
        out["drain"] = http_and_drain(engine, prompt)
    finally:
        engine.stop()
    return out


def mla_engine_phase(torch, dev, card: str, cfg, params: list,
                     kv_int8: bool, bf16_logits=None):
    """mla-8b served through the latent arena: the engine the serve CLI
    builds from ``--model mla-8b`` (``--kv-int8``: int8 latents), 8 slots,
    cache_len 2048, 16-token pages, over the seeded bf16 params in
    ``params`` (a one-element list, emptied by the int8 phase, the last one
    to use them). The arena's shape, the burst with exact launches per step
    (32 latent-kernel launches and 3 norms a layer plus one; no dense paged
    or single-token launch), the independent check against a plain f32
    direct-form forward, HTTP, drain; then the dense-scratch route on an
    engine of its own (``mla_dense_route_phase``). Returns its record and
    the one-chunk last-token logits of the checked prompt (on the host)."""
    from k8s_runpod_kubelet_tpu_torch.ops import (
        paged_attention, paged_attention_mla, paged_attention_mla_quant,
        paged_attention_multi, paged_attention_multi_mla,
        paged_attention_multi_mla_quant, paged_attention_multi_quant,
        paged_attention_quant, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32"]
        + (["--kv-int8"] if kv_int8 else []))
    engine, _ = serve_main.build_engine(args, params[0])
    if kv_int8:
        params.clear()   # the engine holds the last reference
    what = f"{cfg.name}{' --kv-int8' if kv_int8 else ''} engine"
    try:
        sc, store = engine.sc, engine._kv_store
        if not (sc.slots == 8 and sc.cache_len == 2048
                and sc.max_prefill_len == 1024 and sc.kv_page_tokens == 16
                and sc.quantize_kv_int8 == kv_int8):
            raise RuntimeError(f"{what}: the CLI built {sc}")
        r, dr, t = cfg.mla_latent_dim, cfg.mla_rope_dim, 16
        width = torch.empty(0, dtype=cfg.dtype).element_size()
        per_position = r + dr + 8 if kv_int8 else width * (r + dr)
        want = cfg.n_layers * t * per_position
        c = store.arena["c"]
        snap = engine.debug_snapshot()
        if store.pool.n_pages != 2048 or c.shape[1] != 2049 \
                or store.page_bytes != want or snap["kv_layout"] != "latent":
            raise RuntimeError(f"{what}: arena {store.pool.n_pages} + 1 "
                               f"pages of {store.page_bytes} B "
                               f"({snap['kv_layout']}), not 2048 + 1 of "
                               f"{want} (latent)")
        arena_bytes = tensor_bytes(store.arena)
        log(f"  {what}: {cfg.n_layers} layers, E={cfg.embed_dim}, latent "
            f"{r} + rope {dr}, kv {snap['kv']} ({snap['kv_layout']}); arena "
            f"2048 + 1 pages of {store.page_bytes} B, "
            f"{arena_bytes / 1e9:.3f} GB; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        main = paged_attention_multi_mla_quant if kv_int8 \
            else paged_attention_multi_mla
        held = [k for k in (paged_attention_multi_mla,
                            paged_attention_multi_mla_quant,
                            paged_attention_mla, paged_attention_mla_quant,
                            paged_attention_multi,
                            paged_attention_multi_quant, paged_attention,
                            paged_attention_quant) if k is not main]
        per_step = {main.__name__: cfg.n_layers,
                    "rms_norm": 3 * cfg.n_layers + 1,
                    **{k.__name__: 0 for k in held}}
        torch.cuda.reset_peak_memory_stats()
        rec = serve_burst(torch, engine, cfg, card, (main, rms_norm, *held),
                          per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        prompts = rec.pop("prompts")
        prefix = None
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(
                torch, engine, card, MLA_INT8_ENGINE_REL_L2_LIMIT if kv_int8
                else MLA_ENGINE_REL_L2_LIMIT, what)
            if kv_int8:
                logits = quant_logits(torch, engine.model, engine.params,
                                      prompts[2])
            else:
                logits, prefix = prefix_path_check(
                    torch, engine.model, engine.params, prompts[2])
            reference = engine_reference_check(
                torch, cfg, engine.params, prompts[2], logits,
                limit=(MLA_INT8_ENGINE_REL_L2_LIMIT if kv_int8
                       else MLA_ENGINE_REL_L2_LIMIT), what=what)
        if prefix is not None:
            log(f"  prefix path (last-token logits, max abs diff): one chunk "
                f"vs cached prefix + tail {prefix['max_abs_diff']:.4f}; "
                f"cached vs uncached prefix, same tail chunk "
                f"{prefix['cache_vs_uncached_max_abs_diff']:.4f} (logit std "
                f"{prefix['logit_std']:.4f})")
        gap = None
        if bf16_logits is not None:
            ref = bf16_logits.to(logits.device)
            gap = {"rel_l2": ((logits - ref).norm() / ref.norm()).item(),
                   "argmax_agree": bool(logits.argmax() == ref.argmax())}
            log(f"  gap to the bf16-latent engine (information only): "
                f"last-token logits relative L2 {gap['rel_l2']:.4f}, argmax "
                f"agree {gap['argmax_agree']}")
        log(f"  [{card}] peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB")
        rec.update(http_and_drain(engine, rec.pop("prompt")),
                   reference=reference, prefix_path=prefix, gap_to_bf16=gap,
                   page_bytes=store.page_bytes, arena_bytes=arena_bytes,
                   serve_peak_bytes=serve_peak,
                   allocated_bytes=torch.cuda.memory_allocated())
        tree = engine.params
    finally:
        engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {what}: the dense-scratch route (2 slots, cache_len 2048, "
        "kv_pool_pages 256)")
    rec["dense_route"] = mla_dense_route_phase(torch, dev, card, cfg, tree,
                                               kv_int8)
    return rec, logits.cpu()


# -- phase 7l: multi-LoRA on the paged loop ------------------------------------------

def lora_tree(params: dict, adapter: dict) -> dict:
    """``params`` with each adapter target wrapped as a LoRA leaf (the base
    shared, not copied): what ``layer_f32`` merges a layer at a time."""
    layers = dict(params["layers"])
    for t, ad in adapter.items():
        layers[t] = {"w": layers[t], "lora_a": ad["a"], "lora_b": ad["b"],
                     "scale": ad["scale"]}
    return dict(params, layers=layers)


def rel_gap(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def lora_adapters(torch, cfg, params, dev, prompt) -> dict:
    """Three adapters of rank LORA_RANK over every target, each from the
    port's ``apply_lora`` with its own generator, then B redrawn
    N(0, sigma^2) (with B zero an adapter is the base model): sigma starts
    at LORA_SIGMA0 and doubles until the first adapter moves the plain f32
    forward's last-token logits of ``prompt`` by 1.5 x LORA_MIN_MOVE
    (relative L2 to the base's); every adapter must then move them by
    LORA_MIN_MOVE. Returns the adapters (bf16), sigma and each move."""
    from k8s_runpod_kubelet_tpu_torch.models import (LoraConfig, apply_lora,
                                                     extract_adapter)

    lc = LoraConfig(rank=LORA_RANK, targets=LORA_TARGETS_ALL)
    base = reference_logits(torch, cfg, params, prompt)
    draws = []
    for i in range(3):
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        ad = extract_adapter(apply_lora(cfg, params, lc, gen, dev))
        unit = {t: torch.randn(a["b"].shape, generator=gen, device=dev)
                for t, a in ad.items()}
        draws.append((ad, unit))

    def with_sigma(i: int, sigma: float) -> dict:
        ad, unit = draws[i]
        return {t: dict(a, b=(unit[t] * sigma).to(a["b"].dtype))
                for t, a in ad.items()}

    def move(adapter) -> float:
        return rel_gap(reference_logits(torch, cfg, lora_tree(params,
                                                              adapter),
                                        prompt), base)

    sigma, tried = LORA_SIGMA0, []
    while True:
        tried.append((sigma, move(with_sigma(0, sigma))))
        if tried[-1][1] >= 1.5 * LORA_MIN_MOVE or sigma >= LORA_SIGMA_MAX:
            break
        sigma *= 2
    adapters = [with_sigma(i, sigma) for i in range(3)]
    moves = [tried[-1][1]] + [move(a) for a in adapters[1:]]
    log(f"  adapters: rank {LORA_RANK}, targets {','.join(LORA_TARGETS_ALL)}"
        f", B ~ N(0, sigma^2): sigma tried "
        + ", ".join(f"{s:g} -> move {m:.3f}" for s, m in tried)
        + f"; each adapter moves the base's f32 last-token logits by "
        f"{[round(m, 4) for m in moves]} (relative L2, at least "
        f"{LORA_MIN_MOVE})")
    if min(moves) < LORA_MIN_MOVE:
        raise RuntimeError(f"an adapter moves the base's logits by only "
                           f"{min(moves):.4f}: the checks would be vacuous")
    del draws
    return {"adapters": adapters, "sigma": sigma, "moves": moves,
            "sigma_tried": tried}


def lora_engine_phase(torch, dev, card: str, cfg, params, adapters: list,
                      quant: bool = False) -> dict:
    """Phase 7l (or with ``quant`` 7l (e)): the engine the serve CLI
    builds from ``--lora-rank 16 --lora-targets`` (all seven)
    ``--max-adapters 4`` (and ``--int4 --kv-int8``) over ``params`` (phase
    4's bf16 tree, or 7b's quantized one), adapters registered after the
    graph captures. The burst of phase 4 with adapter ids cycling base,
    a1, a2, a3 (every decode batch mixes all four) and exact launches per
    step; an n = 2 group under a2 through the dense-scratch route; then
    (a) each adapter's last-token logits against the plain f32 forward
    over its merged weights, (b) the wrong adapter's merge as a control,
    (c) (g1)-(g5) with mixed ids, a fourth adapter registered and a1
    rewritten without a recapture, a1's trie subtree dropped and its new
    logits checked, the two requests of the shared prefix (base and a1)
    on disjoint pages; the stacks' bytes and the peak memory; drain."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.ops import (flash_fwd, int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    what = "int4/int8 LoRA engine" if quant else "bf16 LoRA engine"
    limit = QUANT_ENGINE_REL_L2_LIMIT if quant else ENGINE_REL_L2_LIMIT
    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32",
         "--lora-rank", str(LORA_RANK), "--lora-targets",
         ",".join(LORA_TARGETS_ALL), "--max-adapters",
         str(LORA_MAX_ADAPTERS)] + (["--int4", "--kv-int8"] if quant else []))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, _ = serve_main.build_engine(args, params)
    try:
        stack_bytes = tensor_bytes(engine._adapters)
        names = ["a1", "a2", "a3"]
        for name, ad in zip(names, adapters):
            engine.register_adapter(name, ad)
        log(f"  {what}: stacks for {LORA_MAX_ADAPTERS} adapters + the base "
            f"slot, {stack_bytes / 1e9:.3f} GB; arena "
            f"{engine._kv_store.pool.n_pages} pages; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
            f"a1-a3 registered after the captures: graphs "
            f"{ {k: g['compiles'] for k, g in engine.graphs_snapshot().items()} }")
        if quant:
            main = (paged_attention_multi_quant, int4_matmul)
            per_step = {"paged_attention_multi_quant": cfg.n_layers,
                        "int4_matmul": 7 * cfg.n_layers + 1,
                        "paged_attention_multi": 0}
        else:
            main = (paged_attention_multi,)
            per_step = {"paged_attention_multi": cfg.n_layers,
                        "paged_attention_multi_quant": 0}
        per_step.update({"rms_norm": 2 * cfg.n_layers + 1,
                         "paged_attention": 0, "paged_attention_quant": 0})
        held = tuple(k for k in (paged_attention_multi,
                                 paged_attention_multi_quant,
                                 paged_attention, paged_attention_quant)
                     if k not in main)
        cycle = ["", *names]
        rec = serve_burst(torch, engine, cfg, card, (*main, rms_norm, *held),
                          per_step, adapters=[cycle[i % 4]
                                              for i in range(8)])
        prompts = rec.pop("prompts")
        prompt = rec.pop("prompt")
        base_pages, a1_pages = (
            {n.page for n in engine._kv_store.trie._nodes.values()
             if root_of(engine, n) == r} for r in (0, 1))
        if not base_pages or not a1_pages or base_pages & a1_pages:
            raise RuntimeError(f"shared-prefix pair: base pages "
                               f"{sorted(base_pages)[:4]}.., a1 pages "
                               f"{sorted(a1_pages)[:4]}..")
        log(f"  the shared 96-token prefix under base and a1: 0 hits, "
            f"{len(base_pages)} and {len(a1_pages)} cached pages, none "
            f"shared")
        # the dense-scratch route: an n = 2 group under a2 prefills once
        heads0 = engine.counters["dense_prefill_heads"]
        f0 = flash_fwd.launches
        group_prompt = prompt(300)
        group = [f.result(timeout=900)["tokens"] for f in
                 engine.submit_group(group_prompt, 2, adapter="a2")]
        heads = engine.counters["dense_prefill_heads"] - heads0
        dense_flash = flash_fwd.launches - f0
        if heads != 1 or dense_flash != cfg.n_layers or group[0] != group[1]:
            raise RuntimeError(f"n = 2 group under a2: {heads} dense heads, "
                               f"{dense_flash} flash_fwd launches, tokens "
                               f"{group}")
        log(f"  n = 2 group under a2: one dense-route prefill head, "
            f"{dense_flash} flash_fwd launches, both greedy members equal")
        serve_peak = torch.cuda.max_memory_allocated()
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card, limit, what)
            # the deltas launch no counted kernel: a replay launches what
            # a step of the engine without adapters does
            for g in engine._graphs():
                per = g.fn.launches_per_replay
                if any(per[k] != n for k, n in per_step.items()):
                    raise RuntimeError(f"{what}: {g.name} replays launch "
                                       f"{per}, not {per_step}")
                log(f"  (c) {g.name}: launches a replay "
                    + ", ".join(f"{k} {per[k]}" for k in per_step))
            checked = prompts[2]
            logits, reference = [], []
            for slot in range(4):
                got = quant_logits(torch, engine.model, engine.params,
                                   checked, kv_int8=quant,
                                   adapters=engine._adapters,
                                   adapter_id=slot)
                tree = (engine.params if slot == 0 else
                        lora_tree(engine.params, adapters[slot - 1]))
                reference.append(reference_logits(torch, cfg, tree, checked))
                logits.append(got)
            gaps = [rel_gap(g, r) for g, r in zip(logits, reference)]
            # (b): each adapter's engine logits against the next adapter's
            # merge (a3 against a1's)
            controls = [rel_gap(logits[s], reference[s % 3 + 1])
                        for s in (1, 2, 3)]
        log(f"  (a) [{card}] {what}, last-token logits of a "
            f"{len(checked)}-token prompt vs the plain f32 forward over "
            f"each merge (base, a1, a2, a3): relative L2 "
            f"{[round(x, 4) for x in gaps]} (limit {limit})")
        log(f"  (b) control, each adapter's logits vs the next adapter's "
            f"merge (a1 vs a2, a2 vs a3, a3 vs a1): "
            f"{[round(x, 4) for x in controls]} (must exceed {limit})")
        if max(gaps) > limit:
            raise RuntimeError(f"{what}: logits off the merged forward: "
                               f"{gaps}")
        if min(controls) <= limit:
            raise RuntimeError(f"{what}: the wrong-adapter control passed: "
                               f"{controls}")
        # (c): a fourth adapter and a rewrite of a1, in place
        new_a1 = {t: dict(a, b=-a["b"]) for t, a in adapters[0].items()}
        a4 = {t: dict(a, b=adapters[1][t]["b"]) for t, a in
              adapters[2].items()}
        had_a1 = 1 in engine.prefix_cache_stats()["adapters"]
        with engine._prefix_lock:
            before = (engine.counters["decode_steps"],
                      sum(g.fn.replays for g in engine._graphs()))
        engine.register_adapter("a4", a4)
        engine.register_adapter("a1", new_a1)
        roots = engine.prefix_cache_stats()["adapters"]
        if not had_a1 or 1 in roots:
            raise RuntimeError(f"a1's trie subtree: before {had_a1}, roots "
                               f"after {roots}")
        for name in ("a1", "a4", ""):
            engine.submit(prompt(200), adapter=name,
                          max_new_tokens=8).result(timeout=900)
        # every graph still captured once, and every decode step since the
        # registrations one replay ((g1)-(g3) replayed outside any step)
        with engine._prefix_lock:
            steps = engine.counters["decode_steps"] - before[0]
            replays = sum(g.fn.replays for g in engine._graphs()) \
                - before[1]
            snap = engine.graphs_snapshot()
        if any(g["compiles"] != 1 for g in snap.values()) \
                or replays != steps or not steps:
            raise RuntimeError(f"{what}: after the registrations {replays} "
                               f"replays for {steps} decode steps, graphs "
                               f"{snap}")
        rec["registration"] = {"graphs": snap, "replays": replays,
                               "decode_steps": steps}
        with engine._prefix_lock:
            got = quant_logits(torch, engine.model, engine.params, checked,
                               kv_int8=quant, adapters=engine._adapters,
                               adapter_id=1)
            want = reference_logits(torch, cfg,
                                    lora_tree(engine.params, new_a1),
                                    checked)
            rewrite = {"rel_l2": rel_gap(got, want),
                       "old_merge_rel_l2": rel_gap(got, reference[1])}
        log(f"  (c) a4 registered and a1 rewritten (B negated) after the "
            f"captures: graphs captured once each, 0 recaptures, "
            f"{replays} replays = {steps} decode steps since; a1's "
            f"trie subtree dropped (roots {roots}); rewritten a1 vs its new "
            f"merge {rewrite['rel_l2']:.4f}, vs the old "
            f"{rewrite['old_merge_rel_l2']:.4f}")
        if rewrite["rel_l2"] > limit or rewrite["old_merge_rel_l2"] <= limit:
            raise RuntimeError(f"{what}: the rewritten a1: {rewrite}")
        log(f"  (d) [{card}] {what}: stacks {stack_bytes / 1e9:.3f} GB; peak "
            f"allocated while serving {serve_peak / 2**30:.2f} GiB")
        rec.update(http_and_drain(engine, prompt),
                   stack_bytes=stack_bytes, serve_peak_bytes=serve_peak,
                   reference={"rel_l2": gaps, "limit_rel_l2": limit,
                              "control_rel_l2": controls,
                              "prompt_tokens": len(checked)},
                   rewrite=rewrite, dense_group={
                       "dense_prefill_heads": heads,
                       "flash_fwd": dense_flash},
                   launches_by_path=dict(
                       rec["launches_by_path"],
                       dense_group={"flash_fwd": dense_flash}))
        return rec
    finally:
        engine.stop()


def root_of(engine, node) -> int:
    """The adapter id whose trie root ``node`` hangs under."""
    while node.parent is not None:
        node = node.parent
    for aid, root in engine._kv_store.trie._roots.items():
        if root.get(node.chunk) is node:
            return aid
    return -1


def lora_profile_phase(torch, dev, card: str, cfg, params) -> dict:
    """7l (d): ``step_profile``'s LoRA profile of the decode replay and the
    1024-token chunk with rank-16 adapters (mixed ids) over all seven
    targets beside the same steps without (``step_profile --lora-rank
    16`` profiles the default targets, wq and wv; here they cost the whole
    smoke 25 s more, PERF.md §6)."""
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import \
        lora_profile

    out = {}
    for label, targets in (("all", LORA_TARGETS_ALL),):
        prof = lora_profile(cfg, dev, params, LORA_RANK, targets)
        out[label] = prof

        def ms(p):
            return p["device_ms"] if isinstance(p["device_ms"], str) \
                else round(p["device_ms"], 4)

        d, c = prof["decode_graph"], prof["prefill"]
        log(f"  (d) [{card}] rank {LORA_RANK} over {','.join(targets)}, "
            f"stacks {prof['stack_bytes'] / 1e9:.3f} GB: decode replay "
            f"device ms base/lora/lora/base {ms(d['base'])} / "
            f"{ms(d['lora'])} / {ms(d['lora_2'])} / {ms(d['base_2'])}; "
            f"1024-token chunk {ms(c['base'])} / {ms(c['lora'])} / "
            f"{ms(c['lora_2'])} / {ms(c['base_2'])}; counted kernels a "
            f"replay {prof['kernels_in_one_replay']['lora']}")
    return out


# -- phase 7f: the other dense families (Gemma-7B, Mistral-7B, Qwen2-7B,
# -- Qwen3-8B) and llama3-70b ---------------------------------------------------------

def draw_family_branches(torch, cfg, params, seed: int,
                         qk_low: float = 0.5) -> None:
    """In place, the leaves the JAX init leaves at identity drawn away from
    it, so a port that ignored a branch misses by far: q/k/v biases N(0,
    0.5^2) (v itself is N(0, ~1.2^2) at these widths), q/k norm weights
    applied at U(qk_low, qk_low + 1), by default U(0.5, 1.5) (drawn at
    U(-0.5, 0.5) when zero-centered; the same uniform numbers for every
    ``qk_low``), zero-centered norm weights N(0, 0.3^2), the sandwich norms
    among them. (A wider q/k
    norm draw sharpens attention until bf16 roundings dominate: the
    qwen3-8b engine read 0.056 / 0.053 / 0.056 / 0.129 / 0.404 off the f32
    forward at identity, U(0.8, 1.25), U(0.5, 1.5), U(0.5, 2.5) and
    U(1.5, 2.5), llama3-8b 0.060 at identity; PERF.md, section 6.)"""
    dev = params["tok_embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = params["layers"]
    for name in ("wq_b", "wk_b", "wv_b"):
        if name in lp:
            lp[name].copy_(torch.randn(lp[name].shape, generator=gen,
                                       device=dev).mul_(0.5))
    # the applied weight (w, or 1 + w when zero-centered) in U(qk_low,
    # qk_low + 1)
    low = qk_low - (1.0 if cfg.norm_zero_centered else 0.0)
    for name in ("q_norm", "k_norm"):
        if name in lp:
            lp[name].uniform_(low, low + 1, generator=gen)
    if cfg.norm_zero_centered:
        for t in (params["final_norm"], lp["attn_norm"], lp["mlp_norm"],
                  *(lp[n] for n in ("attn_post_norm", "mlp_post_norm")
                    if n in lp)):
            t.copy_(torch.randn(t.shape, generator=gen,
                                device=dev).mul_(0.3))


def family_logits(torch, cfg, params, tokens: list[int], drop=(),
                  block: int = 1024) -> "torch.Tensor":
    """Last-token logits (V,) of ``tokens`` from a plain f32 forward of the
    same (dequantized) weights with every branch of ``cfg``: the embedding
    times sqrt(E), zero-centered norms applied as (1 + w), q/k/v biases,
    the per-head q/k RMSNorm before RoPE, causal attention under the
    sliding window (``plain_attention_blocked``), SwiGLU or GeGLU, a tied
    head. No paging, no kernels. ``drop`` names branches to leave out, the
    controls: "bias", "qk_norm", "embed_scale", "gelu" (SiLU in its place),
    "zero_centered" (w for 1 + w), "window" (full causal), "layer" (the
    middle layer skipped)."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import (apply_rope,
                                                       rope_frequencies)

    dev = params["tok_embed"].device
    hd, n = cfg.head_dim_, len(tokens)
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, cfg.rope_theta,
                                cfg.rope_scaling, device=dev)
    window = None if "window" in drop else cfg.sliding_window
    centred = cfg.norm_zero_centered and "zero_centered" not in drop

    def norm(x, w):
        w = w.float()
        return _rms_norm_plain(x, w + 1 if centred else w, cfg.norm_eps)

    x = params["tok_embed"][torch.tensor(tokens, device=dev)].float()[None]
    if cfg.embed_scale and "embed_scale" not in drop:
        x = x * cfg.embed_dim ** 0.5
    for layer in range(cfg.n_layers):
        if "layer" in drop and layer == cfg.n_layers // 2:
            continue
        lp = {k: layer_f32(w, layer) for k, w in params["layers"].items()}
        h = norm(x, lp["attn_norm"])
        q, k, v = (h @ lp[w] for w in ("wq", "wk", "wv"))
        if cfg.qkv_bias and "bias" not in drop:
            q, k, v = q + lp["wq_b"], k + lp["wk_b"], v + lp["wv_b"]
        q = q.view(1, n, cfg.n_heads, hd)
        k = k.view(1, n, cfg.n_kv_heads, hd)
        v = v.view(1, n, cfg.n_kv_heads, hd)
        if cfg.qk_norm and "qk_norm" not in drop:
            q, k = norm(q, lp["q_norm"]), norm(k, lp["k_norm"])
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = plain_attention_blocked(torch, q.transpose(1, 2),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    cfg.sm_scale, block, window)
        x = x + o.transpose(1, 2).reshape(1, n, -1) @ lp["wo"]
        h = norm(x, lp["mlp_norm"])
        gate = h @ lp["w_gate"]
        gate = (F.gelu(gate, approximate="tanh")
                if cfg.mlp_activation == "gelu_tanh" and "gelu" not in drop
                else F.silu(gate))
        x = x + (gate * (h @ lp["w_up"])) @ lp["w_down"]
        del lp, h, q, k, v, o, gate
    x = norm(x[0, -1], params["final_norm"])
    head = (params["tok_embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    return x @ layer_f32(head)


# the controls of each branch, by config field: the reference with the
# branch left out must miss the limit by far
FAMILY_CONTROLS = (("qkv_bias", "bias"), ("qk_norm", "qk_norm"),
                   ("embed_scale", "embed_scale"), ("mlp_activation", "gelu"),
                   ("norm_zero_centered", "zero_centered"))


def family_check(torch, cfg, params, prompt, logits, limit, what,
                 gate=True) -> dict:
    """The engine path's last-token logits against ``family_logits``,
    within ``limit`` (relative L2); each control (a branch of the config
    left out, and the middle layer skipped) must exceed it (with ``gate``
    False all are reported only)."""
    ref = family_logits(torch, cfg, params, prompt)

    def rel(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    drops = [d for f, d in FAMILY_CONTROLS
             if getattr(cfg, f) not in (False, None, "silu")] + ["layer"]
    controls = {d: rel(family_logits(torch, cfg, params, prompt, (d,)))
                for d in drops}
    out = {"prompt_tokens": len(prompt), "rel_l2": rel(logits),
           "argmax_agree": bool(logits.argmax() == ref.argmax()),
           "ref_logit_std": ref.std().item(), "limit_rel_l2": limit,
           "controls_rel_l2": controls}
    log(f"  independent check: {what} vs the plain f32 forward of its "
        f"branches, last-token logits of a {len(prompt)}-token prompt: "
        f"relative L2 {out['rel_l2']:.4f} (limit {limit}), argmax agree "
        f"{out['argmax_agree']}; controls "
        + ", ".join(f"{d} dropped {v:.4f}" for d, v in controls.items()))
    if gate and not out["rel_l2"] <= limit:
        raise RuntimeError(f"{what} logits off the plain forward: {out}")
    if gate and not all(v > limit for v in controls.values()):
        raise RuntimeError(f"{what}: a control passed the check: {out}")
    return out


def dense_layer_check(torch, model, params, prompt, kv_int8) -> dict:
    """A dense Llama engine path held one layer at a time, as phase 7m
    holds Mixtral's: the one-chunk prefill of ``prompt`` (over an int8
    arena with ``kv_int8``) runs with each layer's MLP input and output
    recorded (the engine's own residual stream) and each sublayer's
    output before its residual add (the ``wo`` and ``w_down``
    products: recovering it as a difference of two bf16 residual states
    would add the residual's own rounding, which grows with depth), and
    each layer's attention and MLP outputs are held against the plain f32
    layer (``plain_attention`` over unquantized K/V, ``plain_mlp``) of the
    (dequantized) weights on that same input, within
    ``MOE_LAYER_REL_L2_LIMIT``. Controls, which must read above it in
    every layer: each sublayer with the next layer's weights."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import rope_frequencies

    cfg = model.cfg
    seen, sub = [], []
    paged_mlp, proj = model._paged_mlp, model._proj

    def record(x, lp, layer, *adapter):
        out = paged_mlp(x, lp, layer, *adapter)
        seen.append((x.clone(), out.clone()))
        return out

    def record_proj(h, w, name, *args, **kw):
        y = proj(h, w, name, *args, **kw)
        if name in ("wo", "w_down"):
            sub.append(y.clone())
        return y

    model._paged_mlp, model._proj = record, record_proj
    try:
        quant_logits(torch, model, params, prompt, kv_int8=kv_int8)
    finally:
        del model._paged_mlp, model._proj
    if len(seen) != cfg.n_layers or len(sub) != 2 * cfg.n_layers:
        raise RuntimeError(f"recorded {len(seen)} MLP calls, {len(sub)} "
                           "sublayer outputs")
    dev = params["tok_embed"].device
    cos, sin = rope_frequencies(cfg.head_dim_, cfg.max_seq_len,
                                cfg.rope_theta, cfg.rope_scaling, device=dev)

    def rel(a, ref):
        return ((a - ref).norm() / ref.norm()).item()

    def weights(layer):
        return {k: layer_f32(w, layer) for k, w in params["layers"].items()}

    rows = []
    x_in = params["tok_embed"][torch.tensor([prompt], device=dev)].float()
    lp = weights(0)
    for layer in range(cfg.n_layers):
        nxt = weights((layer + 1) % cfg.n_layers)
        mid, out = (t.float() for t in seen[layer])
        attn, mlp = (t.float() for t in sub[2 * layer:2 * layer + 2])
        h = _rms_norm_plain(mid, lp["mlp_norm"], cfg.norm_eps)
        rows.append({
            "layer": layer,
            "attn_rel_l2": rel(attn, plain_attention(
                torch, cfg, lp, x_in, cos, sin)),
            "mlp_rel_l2": rel(mlp, plain_mlp(torch, F, cfg, lp, h)),
            "attn_control_rel_l2": rel(attn, plain_attention(
                torch, cfg, nxt, x_in, cos, sin)),
            "mlp_control_rel_l2": rel(mlp, plain_mlp(
                torch, F, cfg, nxt, h))})
        x_in, lp = out, nxt
    worst = {k: max(r[k] for r in rows)
             for k in ("attn_rel_l2", "mlp_rel_l2")}
    ctrl = {k: min(r[k] for r in rows)
            for k in ("attn_control_rel_l2", "mlp_control_rel_l2")}
    res = {"limit_rel_l2": MOE_LAYER_REL_L2_LIMIT, "worst": worst,
           "controls_least": ctrl, "layers": rows}
    log(f"  layer check: each of {cfg.n_layers} layers against the plain f32 "
        f"layer on the engine's own input ({len(prompt)} tokens): worst "
        f"attention {worst['attn_rel_l2']:.4f}, worst MLP "
        f"{worst['mlp_rel_l2']:.4f} relative L2 (limit "
        f"{MOE_LAYER_REL_L2_LIMIT}); controls (the next layer's weights) at "
        f"least {ctrl['attn_control_rel_l2']:.3f} and "
        f"{ctrl['mlp_control_rel_l2']:.3f}")
    if not max(worst.values()) <= MOE_LAYER_REL_L2_LIMIT:
        raise RuntimeError(f"a layer is off the plain f32 layer: {res}")
    if not min(ctrl.values()) > MOE_LAYER_REL_L2_LIMIT:
        raise RuntimeError(f"a layer check control passed: {res}")
    return res


def event_ms(torch, fn, reps: int = 10) -> float:
    """Median time between two CUDA events recorded around ``fn`` (after
    one untimed call): the card's timeline, its idle gaps between
    launches included (a graph replay has few; an eager chunk many)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def family_step_times(torch, engine) -> dict:
    """The decode step as the engine runs it (one replay of its graph over
    8 slots at ``GRAPH_LENGTHS`` contexts, pages from its own pool) and a
    1024-token prefill chunk behind nothing, each timed by ``event_ms``.
    The caller holds the arena lock."""
    import numpy as np

    store, model, params = engine._kv_store, engine.model, engine.params
    dev, t = engine.device, engine.sc.kv_page_tokens
    cols, b = engine._slot_pages_max, engine.sc.slots
    g = engine._paged_step.fn
    lengths = np.array(GRAPH_LENGTHS[:b], np.int32)
    need = -(-(lengths + 1) // t)
    chunk_pages = -(-CHUNK_TOKENS // t)
    pages = store.alloc_run(int(need.sum()) + chunk_pages)
    try:
        table = np.zeros((b, cols), np.int32)
        at = 0
        for i in range(b):
            table[i, :need[i]] = pages[at:at + need[i]]
            at += need[i]
        toks = np.arange(b, dtype=np.int32)[:, None]
        active = np.ones(b, bool)
        decode_ms = event_ms(torch, lambda: g.run(
            params, store.arena, toks, lengths, table, active))
        ctable = torch.zeros((1, cols), dtype=torch.int32, device=dev)
        ctable[0, :chunk_pages] = torch.tensor(pages[at:], device=dev)
        ctoks = torch.arange(CHUNK_TOKENS, device=dev,
                             dtype=torch.int32)[None] % engine.cfg.vocab_size
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        n = torch.tensor([CHUNK_TOKENS], dtype=torch.int32, device=dev)
        chunk_ms = event_ms(torch, lambda: model.paged_prefill_chunk_step(
            params, ctoks, store.arena, ctable, zero, n), reps=5)
    finally:
        store.release(pages)
    return {"decode_replay_event_ms": decode_ms,
            "chunk_event_ms": chunk_ms, "chunk_tokens": CHUNK_TOKENS,
            "decode_lengths": lengths.tolist()}


def family_engine_run(torch, dev, card: str, cfg, params, quant: bool,
                      what: str) -> dict:
    """One family through the engine the serve CLI builds (``--model
    <name>``, 8 slots, cache_len 2048, 16-token pages; with ``quant``
    ``--int4 --kv-int8``, quantized on the card from ``params``): the burst
    with exact launches per step and chunk, (g1)-(g5), the serving peak,
    the decode replay's and a chunk's time (``event_ms``), and the check
    against ``family_logits`` (limit 0.1, or 0.15 under int4 weights over
    an int8 arena) with every branch's control outside it."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    argv = ["--model", cfg.name, "--device", dev.type, "--slots", "8",
            "--cache-len", "2048", "--max-new-tokens", "32"]
    if quant:
        argv += ["--int4", "--kv-int8"]
    torch.cuda.reset_peak_memory_stats()
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), params)
    limit = QUANT_ENGINE_REL_L2_LIMIT if quant else ENGINE_REL_L2_LIMIT
    try:
        n = cfg.n_layers
        attn = paged_attention_multi_quant if quant else paged_attention_multi
        other = paged_attention_multi if quant else paged_attention_multi_quant
        # the paged kernel once a layer; the norm kernel twice a layer and
        # once, and with the q/k norm twice a layer more
        per_step = {attn.__name__: n, other.__name__: 0,
                    "rms_norm": (4 if cfg.qk_norm else 2) * n + 1,
                    "paged_attention": 0, "paged_attention_quant": 0}
        kernels = [attn, other, rms_norm, paged_attention,
                   paged_attention_quant]
        if quant:
            # seven products a layer; a tied head is the bf16 embedding's
            # transpose (cuBLAS), as in the JAX package
            per_step["int4_matmul"] = 7 * n + (0 if cfg.tie_embeddings
                                               else 1)
            kernels.append(int4_matmul)
        log(f"  {what}: {n} layers, E={cfg.embed_dim}, heads "
            f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim_}; arena "
            f"{engine._kv_store.pool.n_pages} pages of "
            f"{engine._kv_store.page_bytes} B; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
            f"per step {per_step}")
        torch.cuda.reset_peak_memory_stats()
        rec = serve_burst(torch, engine, cfg, card, tuple(kernels), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        prompts = rec.pop("prompts")
        rec.pop("prompt")
        with engine._prefix_lock:   # the engine is idle; keep it so
            rec["graphs"] = graph_checks(torch, engine, card, limit, what)
            rec["times"] = family_step_times(torch, engine)
            logits = quant_logits(torch, engine.model, engine.params,
                                  prompts[2], kv_int8=quant)
            rec["reference"] = family_check(torch, cfg, engine.params,
                                            prompts[2], logits, limit, what)
        rec["serve_peak_bytes"] = serve_peak
        rec["weight_bytes"] = tensor_bytes(engine.params)
        log(f"  [{card}] {what}: peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB (weights "
            f"{rec['weight_bytes'] / 1e9:.3f} GB); decode replay "
            f"{rec['times']['decode_replay_event_ms']:.3f} ms, "
            f"{CHUNK_TOKENS}-token chunk "
            f"{rec['times']['chunk_event_ms']:.3f} ms (between CUDA events)")
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def window_run(torch, dev, card: str, cfg, params) -> dict:
    """Mistral's 4096-token window past its edge, through the engine the
    serve CLI builds at ``--cache-len 8192``: one prompt of
    ``WINDOW_PROMPT`` tokens (two chunks), greedy for ``WINDOW_DECODE``
    tokens. The step records' ``ring_recycled`` must be > 0 and equal the
    table entries past the prompt's run; the slot's distinct pages stay at
    the prompt's run (its pages are a linear run, recycling starts at
    decode and allocates nothing). The final step's logits (the decode
    graph's output when the last token was sampled) must lie within
    ``ENGINE_REL_L2_LIMIT`` of ``family_logits`` over prompt + generated
    tokens under the window, and the full-causal forward must miss it.
    Then a ``--speculate 4`` engine takes no speculative step."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    t = 16
    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "8192", "--max-new-tokens", str(WINDOW_DECODE)])
    engine, _ = serve_main.build_engine(args, params)
    rng = np.random.default_rng(SEED + 7)
    prompt = [int(x) for x in rng.integers(0, cfg.vocab_size, WINDOW_PROMPT)]
    seen: dict = {"held": []}

    def on_token(_tok):
        i, slot = next((i, s) for i, s in enumerate(engine._slots)
                       if s.request is not None)
        seen["held"].append((len(set(slot.pages)), len(slot.pages),
                             slot.table_len))
        logits = engine._paged_step.fn.logits
        if len(seen["held"]) > 1 and logits is not None:
            seen["logits"] = logits[i].clone()

    try:
        seq0 = last_seq(engine)
        t0 = time.perf_counter()
        res = engine.submit(prompt, on_token=on_token).result(timeout=900)
        wall = time.perf_counter() - t0
        gen = res["tokens"]
        recycled = sum(r.get("arena", {}).get("ring_recycled", 0)
                       for r in engine.recorder.records()
                       if r["seq"] > seq0)
        distinct, listed, table_len = seen["held"][-1]
        run = -(-WINDOW_PROMPT // t)
        positions = WINDOW_PROMPT + len(gen) - 1
        if not (recycled > 0 and recycled == table_len - run
                and distinct == listed == max(run, engine._win_pages)
                and table_len == -(-positions // t)):
            raise RuntimeError(
                f"window ring: recycled {recycled}, slot pages {distinct} "
                f"distinct of {listed}, table {table_len} entries, prompt "
                f"run {run}, _win_pages {engine._win_pages}")
        log(f"  mistral-7b window {cfg.sliding_window}: a "
            f"{WINDOW_PROMPT}-token prompt + {len(gen)} greedy tokens in "
            f"{wall:.1f} s; {positions} positions over {table_len} table "
            f"entries held in {distinct} pages (the prompt's run; "
            f"_win_pages {engine._win_pages}), ring_recycled {recycled}")
        ctx = prompt + gen[:-1]
        with engine._prefix_lock:
            ref = family_logits(torch, cfg, engine.params, ctx)
            full = family_logits(torch, cfg, engine.params, ctx, ("window",))
        got = seen["logits"].float()

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        check = {"context_tokens": len(ctx), "rel_l2": rel(got, ref),
                 "full_causal_rel_l2": rel(got, full),
                 "window_vs_full_rel_l2": rel(full, ref),
                 "argmax_agree": bool(got.argmax() == ref.argmax()),
                 "limit_rel_l2": ENGINE_REL_L2_LIMIT}
        log(f"  final step's logits (context {len(ctx)}) vs the plain f32 "
            f"windowed forward: relative L2 {check['rel_l2']:.4f} (limit "
            f"{ENGINE_REL_L2_LIMIT}), argmax agree {check['argmax_agree']}; "
            f"control: vs the full-causal forward "
            f"{check['full_causal_rel_l2']:.4f} (the two references "
            f"{check['window_vs_full_rel_l2']:.4f} apart)")
        if not check["rel_l2"] <= ENGINE_REL_L2_LIMIT:
            raise RuntimeError(f"windowed engine off the forward: {check}")
        if not check["full_causal_rel_l2"] > ENGINE_REL_L2_LIMIT:
            raise RuntimeError(f"the full-causal control passed: {check}")
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    args = serve_main.parse_args(
        ["--model", cfg.name, "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "16", "--speculate",
         "4"])
    engine, _ = serve_main.build_engine(args, params)
    try:
        # a repeated prompt: a speculative engine would draft from it
        out = engine.submit((prompt[:50] * 4)[:200]).result(timeout=900)
        spec = {"paged_speculative_steps":
                engine.counters["paged_speculative_steps"],
                "decode_steps": engine.counters["decode_steps"],
                "graphs": sorted(engine.graphs_snapshot()),
                "tokens": len(out["tokens"])}
        log(f"  --speculate 4 on the window: {spec}")
        if spec["paged_speculative_steps"] or spec["graphs"] != [
                "paged_step"] or not spec["decode_steps"]:
            raise RuntimeError(f"a windowed engine speculated: {spec}")
    finally:
        engine.stop()
    return {"prompt_tokens": WINDOW_PROMPT, "generated": len(gen),
            "wall_s": wall, "ring_recycled": recycled,
            "slot_pages": distinct, "table_entries": table_len,
            "win_pages": cfg.sliding_window // t + 2,
            "check": check, "speculate": spec}


def families_phase(torch, dev, card: str) -> dict:
    """Phase 7f: gemma-7b, qwen2-7b, qwen3-8b and mistral-7b, one at a
    time at full width and depth, bf16 weights from the seed with their
    branch leaves drawn away from identity (``draw_family_branches``):
    ``family_engine_run`` each; ``--int4 --kv-int8`` on gemma-7b and
    qwen2-7b; Mistral's window past its edge (``window_run``)."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS, init_params

    out = {}
    for i, name in enumerate(FAMILY_MODELS):
        cfg = MODEL_CONFIGS[name]()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED + i), dev)
        draw_family_branches(torch, cfg, params, SEED + 100 + i)
        torch.cuda.synchronize()
        log(f"phase 7f: {name} (bf16, branches drawn away from identity; "
            f"drawn in {time.perf_counter() - t0:.1f} s)")
        rec = {"bf16": family_engine_run(torch, dev, card, cfg, params,
                                         False, f"{name} bf16 engine")}
        if name in FAMILY_INT4:
            log(f"phase 7f: {name} --int4 --kv-int8")
            rec["int4_kv_int8"] = family_engine_run(
                torch, dev, card, cfg, params, True,
                f"{name} int4/int8 engine")
        if cfg.sliding_window is not None:
            log(f"phase 7f: {name} past its window (cache_len 8192)")
            rec["window"] = window_run(torch, dev, card, cfg, params)
        out[name] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def llama70b_phase(torch, dev, card: str) -> dict:
    """llama3-70b (80 layers, E 8192) on one card through ``--model
    llama3-70b --int4 --kv-int8``: weights drawn from the seed and
    quantized a layer at a time (the bf16 tree, 141 GB, never exists);
    weight, arena and peak bytes; the burst with exact launches per step;
    (g1)-(g5); the check against the plain f32 forward of the dequantized
    weights, reported (0.3089 in its first run, above the skipped-layer
    control's 0.2407: 80 random layers amplify the bf16 and int8 roundings
    past what one layer left out moves), and gated layer by layer
    (``dense_layer_check``, as phase 7m gates Mixtral)."""
    from k8s_runpod_kubelet_tpu_torch.ops import (int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    args = serve_main.parse_args(
        ["--model", "llama3-70b", "--device", dev.type, "--slots", "8",
         "--cache-len", "2048", "--max-new-tokens", "32", "--int4",
         "--kv-int8", "--seed", str(SEED)])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _ = serve_main.build_engine(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    try:
        cfg, p = engine.cfg, engine.params
        weights = {
            "q4": sum(w["q4"].numel() for w in p["layers"].values()
                      if isinstance(w, dict)) + p["lm_head"]["q4"].numel(),
            "scales": sum(w["scale"].numel() * 4
                          for w in p["layers"].values()
                          if isinstance(w, dict))
            + p["lm_head"]["scale"].numel() * 4,
            "tok_embed": tensor_bytes(p["tok_embed"]),
            "norms": tensor_bytes(p["final_norm"]) + sum(
                tensor_bytes(w) for n, w in p["layers"].items()
                if n.endswith("norm"))}
        arena = tensor_bytes(engine._kv_store.arena)
        log(f"  llama3-70b: {cfg.n_layers} layers, E={cfg.embed_dim}; drawn "
            f"and quantized on the card in {build_s:.1f} s (graphs "
            "captured); weight bytes "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in weights.items())
            + f"; arena {engine._kv_store.pool.n_pages} pages, "
            f"{arena / 1e9:.3f} GB; [{card}] allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak while "
            f"building {build_peak / 2**30:.2f} GiB")
        if not build_peak < CARD_BYTES:
            raise RuntimeError(f"peak {build_peak} B while building")
        torch.cuda.reset_peak_memory_stats()
        n = cfg.n_layers
        per_step = {"paged_attention_multi_quant": n,
                    "int4_matmul": 7 * n + 1, "rms_norm": 2 * n + 1,
                    "paged_attention_multi": 0, "paged_attention": 0,
                    "paged_attention_quant": 0}
        rec = serve_burst(torch, engine, cfg, card,
                          (paged_attention_multi_quant, int4_matmul, rms_norm,
                           paged_attention_multi, paged_attention,
                           paged_attention_quant), per_step)
        serve_peak = torch.cuda.max_memory_allocated()
        prompts = rec.pop("prompts")
        rec.pop("prompt")
        with engine._prefix_lock:
            rec["graphs"] = graph_checks(torch, engine, card,
                                         QUANT_ENGINE_REL_L2_LIMIT,
                                         "llama3-70b int4/int8 engine")
            rec["times"] = family_step_times(torch, engine)
            logits = quant_logits(torch, engine.model, p, prompts[2])
            rec["reference"] = family_check(
                torch, cfg, p, prompts[2], logits, QUANT_ENGINE_REL_L2_LIMIT,
                "llama3-70b int4/int8 engine", gate=False)
            rec["layer_check"] = dense_layer_check(
                torch, engine.model, p, prompts[2], kv_int8=True)
        log(f"  [{card}] llama3-70b: peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB; decode replay "
            f"{rec['times']['decode_replay_event_ms']:.3f} ms, "
            f"{CHUNK_TOKENS}-token chunk "
            f"{rec['times']['chunk_event_ms']:.3f} ms (between CUDA events)")
        rec.update(weight_bytes=weights, arena_bytes=arena,
                   build_s=build_s, build_peak_bytes=build_peak,
                   serve_peak_bytes=serve_peak)
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 7g: Gemma 2 and 3 on the contiguous decode loop ---------------------------

def interleave_logits(torch, cfg, params, tokens: list[int], drop=(),
                      block: int = 1024, rounding=None) -> "torch.Tensor":
    """Last-token logits (V,) of ``tokens`` from a plain f32 forward of the
    same (dequantized) weights with every branch of a Gemma 2 or 3 config
    (and a plain Llama's): the embedding times sqrt(E), zero-centered
    norms, the q/k norm, each layer's window (``layer_windows``) and RoPE
    table (the local base on windowed layers, unscaled), the score soft
    cap before the mask, the sandwich norms, GeGLU, a tied head, the
    logit soft cap. No cache, no kernels. ``drop`` names the controls:
    "softcap" (both caps left out), "post_norms", "global_window" (the
    global layers' full causal mask on the local layers too),
    "global_rope" (the global table on the local layers), "layer" (the
    middle layer skipped). With ``rounding`` (a dtype) every value a
    model computing in that dtype stores (each product, norm, RoPE,
    attention output, residual and the logits) is rounded to it: a plain
    bf16 forward that shares no code with the model's steps."""
    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import rope_frequencies

    dev = params["tok_embed"].device
    hd = cfg.head_dim_
    glob = rope_frequencies(hd, cfg.max_seq_len, cfg.rope_theta,
                            cfg.rope_scaling, device=dev)
    loc = (glob if cfg.rope_local_theta is None else
           rope_frequencies(hd, cfg.max_seq_len, cfg.rope_local_theta, None,
                            device=dev))
    windows = cfg.layer_windows()
    cap = None if "softcap" in drop else cfg.attn_logit_softcap
    post = cfg.post_norms and "post_norms" not in drop

    def r(t):
        return t if rounding is None else t.to(rounding).float()

    def norm(x, w):
        w = w.float()
        return r(_rms_norm_plain(x, w + 1 if cfg.norm_zero_centered else w,
                                 cfg.norm_eps))

    x = params["tok_embed"][torch.tensor(tokens, device=dev)].float()[None]
    if cfg.embed_scale:
        x = r(x * cfg.embed_dim ** 0.5)
    for layer in range(cfg.n_layers):
        if "layer" in drop and layer == cfg.n_layers // 2:
            continue
        window = windows[layer % len(windows)]
        local = window is not None
        if "global_window" in drop:
            window = None
        rope = loc if local and "global_rope" not in drop else glob
        lp = {k: layer_f32(w, layer) for k, w in params["layers"].items()}
        x = interleave_layer(torch, cfg, lp, x, window, rope, cap, post,
                             norm, r, block)
        del lp
    x = norm(x[0, -1], params["final_norm"])
    head = (params["tok_embed"].t() if cfg.tie_embeddings
            else params["lm_head"])
    logits = r(x @ layer_f32(head))
    if cfg.logit_softcap and "softcap" not in drop:
        logits = r(torch.tanh(logits / cfg.logit_softcap)
                   * cfg.logit_softcap)
    return logits


def interleave_layer(torch, cfg, lp, x, window, rope, cap, post, norm, r,
                     block: int):
    """One decoder layer of ``interleave_logits``'s plain f32 forward on
    the residual stream x (B, n, E) from its f32 leaves ``lp``: the normed
    q/k/v (the q/k norm), RoPE from ``rope`` (cos, sin), attention under
    ``window`` and the score cap ``cap`` (``plain_attention_blocked``),
    the sandwich norms with ``post``, GeGLU or SwiGLU. ``norm(x, w)`` is
    the config's RMSNorm and ``r`` the rounding each stored value takes
    (the identity in f32)."""
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops.rope import apply_rope

    b, n, _ = x.shape
    hd = cfg.head_dim_
    cos, sin = rope
    h = norm(x, lp["attn_norm"])
    q = r(h @ lp["wq"]).view(b, n, cfg.n_heads, hd)
    k = r(h @ lp["wk"]).view(b, n, cfg.n_kv_heads, hd)
    v = r(h @ lp["wv"]).view(b, n, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q, k = norm(q, lp["q_norm"]), norm(k, lp["k_norm"])
    q, k = r(apply_rope(q, cos, sin)), r(apply_rope(k, cos, sin))
    o = r(plain_attention_blocked(torch, q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), cfg.sm_scale, block,
                                  window, cap))
    o = r(o.transpose(1, 2).reshape(b, n, -1) @ lp["wo"])
    x = r(x + (norm(o, lp["attn_post_norm"]) if post else o))
    h = norm(x, lp["mlp_norm"])
    gate = r(h @ lp["w_gate"])
    gate = r(F.gelu(gate, approximate="tanh")
             if cfg.mlp_activation == "gelu_tanh" else F.silu(gate))
    y = r(r(gate * r(h @ lp["w_up"])) @ lp["w_down"])
    return r(x + (norm(y, lp["mlp_post_norm"]) if post else y))


def interleave_drops(cfg, n_tokens: int) -> list[str]:
    """The controls of ``interleave_logits`` that change ``cfg``'s
    forward over ``n_tokens`` tokens (a window bites only past its
    length)."""
    drops = []
    if cfg.attn_logit_softcap or cfg.logit_softcap:
        drops.append("softcap")
    if cfg.post_norms:
        drops.append("post_norms")
    if (cfg.sliding_window is not None and cfg.sliding_window_pattern > 1
            and n_tokens > cfg.sliding_window):
        drops.append("global_window")
    if cfg.rope_local_theta is not None:
        drops.append("global_rope")
    return drops + ["layer"]


def interleave_check(torch, cfg, params, tokens, logits, limit, what,
                     extra=None) -> dict:
    """Engine logits against ``interleave_logits`` within ``limit``
    (relative L2); every control of ``interleave_drops`` and each of
    ``extra`` ({name: logits}, the engine path broken) must miss it."""
    ref = interleave_logits(torch, cfg, params, tokens)

    def rel(a):
        return ((a.float() - ref).norm() / ref.norm()).item()

    controls = {d: rel(interleave_logits(torch, cfg, params, tokens, (d,)))
                for d in interleave_drops(cfg, len(tokens))}
    controls.update({name: rel(v) for name, v in (extra or {}).items()})
    out = {"tokens": len(tokens), "rel_l2": rel(logits),
           "argmax_agree": bool(logits.argmax() == ref.argmax()),
           "ref_logit_std": ref.std().item(), "limit_rel_l2": limit,
           "controls_rel_l2": controls}
    log(f"  independent check: {what} vs the plain f32 forward of its "
        f"branches, last-token logits over {len(tokens)} tokens: relative "
        f"L2 {out['rel_l2']:.4f} (limit {limit}), argmax agree "
        f"{out['argmax_agree']}; controls "
        + ", ".join(f"{d} {v:.4f}" for d, v in controls.items()))
    if not out["rel_l2"] <= limit:
        raise RuntimeError(f"{what} logits off the plain forward: {out}")
    if not all(v > limit for v in controls.values()):
        raise RuntimeError(f"{what}: a control passed the check: {out}")
    return out


def contiguous_burst(torch, engine, cfg, card: str, kernels, per_step,
                     flash_per_head: int) -> dict:
    """Phase 4's 8-request burst through the contiguous loop, its 96-token
    shared prefix registered first (the dense store: both prompts that
    start with it copy its cache), then a repeat. Launch counts are set to
    0 just before the burst and read just after: each kernel of
    ``per_step`` launches that many times a decode step or prefill call
    (a head through ``prefill`` or a chunk through ``prefill_chunk_step``;
    0: never), ``flash_fwd`` ``flash_per_head`` times a head."""
    from k8s_runpod_kubelet_tpu_torch.ops import flash_fwd

    warm, prompts, _ = burst_prompts(cfg)
    engine.submit(warm, max_new_tokens=4).result(timeout=900)
    engine.register_prefix(prompts[0][:96])

    def snap() -> dict:
        with engine._prefix_lock:
            c = engine.counters
            return {"heads": c["dense_prefill_heads"],
                    "chunks": c["dense_prefill_chunks"],
                    "decode_steps": c["decode_steps"],
                    "prefix_hits": c["prefix_hits"],
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    with engine._prefix_lock:
        for k in kernels:
            k.launches = 0
    s0 = snap()
    seq0 = last_seq(engine)
    t0 = time.perf_counter()
    futs = [engine.submit(p) for p in prompts]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    s1 = snap()
    d = {k: s1[k] - s0[k] for k in s0}
    launches = {k.__name__: d[k.__name__] for k in kernels}
    calls = d["heads"] + d["chunks"] + d["decode_steps"]
    if d["replays"] != d["decode_steps"]:
        raise RuntimeError(f"{d['replays']} graph replays for "
                           f"{d['decode_steps']} decode steps")
    want = {name: n * calls for name, n in per_step.items()}
    want["flash_fwd"] = flash_per_head * d["heads"]
    for name, need in want.items():
        got = d[name]
        if got != need or (name in per_step and per_step[name] and got < 1):
            raise RuntimeError(
                f"burst: {name} launched {got} times in {d['heads']} heads, "
                f"{d['chunks']} chunks and {d['decode_steps']} decode "
                f"steps, not {need}")
    if len(results) != 8 or any(len(r["tokens"]) != 32 for r in results):
        raise RuntimeError("not all 8 requests finished with 32 tokens")
    if d["prefix_hits"] != 2:
        raise RuntimeError(f"{d['prefix_hits']} registered-prefix hits, "
                           "not the two prompts that start with it")
    recorder = (recorder_stats(engine, seq0, "burst", card)
                if engine.recorder is not None else None)
    ttft = [r["ttft_s"] for r in results]
    per_stream = [(len(r["tokens"]) - 1) / (r["latency_s"] - r["ttft_s"])
                  for r in results]
    out_tok_s = sum(len(r["tokens"]) for r in results) / wall
    log(f"  8/8 requests ({sum(len(p) for p in prompts)} prompt tokens) in "
        f"{wall:.2f} s; {d['heads']} prefill heads, {d['chunks']} chunks, "
        f"{d['decode_steps']} decode steps (= replays); registered-prefix "
        f"hits {d['prefix_hits']}; launches {launches}")
    log(f"  [{card}] TTFT median {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{max(ttft) * 1e3:.1f} ms; decode "
        f"{statistics.median(per_stream):.1f} tokens/s per stream (median), "
        f"{out_tok_s:.1f} output tokens/s over the phase")
    rep = [engine.submit(prompts[2]).result(timeout=900)["tokens"]
           for _ in range(2)]
    if rep[0] != rep[1]:
        raise RuntimeError(f"repeat differs: {rep[0]} vs {rep[1]}")
    return {"launches": launches, "counts": d, "launches_per_step": per_step,
            "flash_per_head": flash_per_head, "recorder": recorder,
            "ttft_ms": [x * 1e3 for x in ttft],
            "decode_tok_s_per_stream": per_stream,
            "output_tok_s": out_tok_s, "wall_s": wall,
            "prompt_lengths": [len(p) for p in prompts],
            "repeat_same_as_first": sum(
                a == b for a, b in zip(rep[0], results[2]["tokens"])),
            "prompts": prompts}


def contiguous_graph_checks(torch, engine, card: str, limit: float,
                            what: str, ids=None, verify: bool = False
                            ) -> dict:
    """(g1)-(g5) of the contiguous loop's decode graph (with ``verify`` its
    K + 1-wide verify graph) on an idle engine, its lock held by the
    caller: (g5) first; then the batch cache filled with seeded random
    rows at the burst's contexts (``GRAPH_LENGTHS``, slot 3 inactive),
    (g1) two replays against the eager ``decode_step`` (``verify_step``)
    on a copy of the cache, logits and every section (exact, or held to
    ``limit``); (g2) the graph's kernel nodes by name against the
    capture's launches; (g3) the step wall eager / graph / graph / eager;
    (g4) device memory around the capture. On an engine that serves
    adapters every step takes its stacks and ``ids``, one adapter slot a
    row (mixed: 0 is the base)."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.workloads.serving.step_graph import \
        KERNEL_NAMES
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import (
        fill_contiguous_cache)

    out = {"g5": graphs_used_check(engine, what)}
    model, params, cache = engine.model, engine.params, engine._cache
    wrapped = engine._verify if verify else engine._decode
    g, kind = wrapped.fn, wrapped.name
    b, dev = engine.sc.slots, engine.device
    shape = (b, g.width) if verify else (b,)

    def step(toks_t, cache, active_t, **kw):
        if verify:
            return model.verify_step(params, toks_t, cache, active_t,
                                     check=False, **kw)
        return model.decode_step(params, toks_t, cache, active_t,
                                 check=False, **kw)

    run_kw, step_kw = {}, {}
    if engine._adapters is not None:
        ids = np.asarray(ids if ids is not None else np.zeros(b), np.int32)
        run_kw = {"adapters": engine._adapters, "adapter_ids": ids}
        step_kw = {"adapters": engine._adapters,
                   "adapter_ids": torch.from_numpy(ids).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    fill_contiguous_cache(cache, gen, torch.tensor(GRAPH_LENGTHS[:b],
                                                   dtype=torch.int32))
    active = np.ones(b, bool)
    active[3] = False
    act_t = torch.from_numpy(active).to(dev)
    copy = {k: v.clone() for k, v in cache.items()}
    rows = []
    for n_step in (0, 1):
        toks = rng.integers(0, engine.cfg.vocab_size, shape).astype(np.int32)
        got = g.run(params, cache, toks, active, **run_kw).clone()
        want, _ = step(torch.from_numpy(toks).to(dev), copy, act_t,
                       **step_kw)
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        rel = ((got - want).norm() / want.norm()).item()
        sections = {name: 0.0 if torch.equal(cache[name], copy[name]) else
                    ((cache[name].float() - copy[name].float()).abs().max()
                     / copy[name].float().abs().max()).item()
                    for name in cache}
        rows.append({"step": n_step, "logits_max_abs_diff": diff,
                     "logits_rel_l2": rel, "cache_rel_max_diff": sections,
                     "exact": diff == 0 and not any(sections.values())})
        if not rows[-1]["exact"] and not (
                rel <= limit and max(sections.values()) <= limit):
            raise RuntimeError(f"{what}: {kind} graph off the eager step: "
                               f"{rows[-1]}")
    del copy
    toks = rng.integers(0, engine.cfg.vocab_size, shape).astype(np.int32)
    want = {k: g.launches_per_replay[k] for k in KERNEL_NAMES}
    counts = g.kernels_in_graph()
    if counts != want:
        raise RuntimeError(f"{what}: the {kind} graph holds {counts}, the "
                           f"capture recorded {g.launches_per_replay}")

    def timed(fn) -> float:
        walls = []
        for _ in range(GRAPH_TIMED_STEPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3

    tok_t = torch.from_numpy(toks).to(dev)

    def eager():
        step(tok_t, cache, act_t, **step_kw)

    def replay():
        g.run(params, cache, toks, active, **run_kw)

    turns = [timed(eager), timed(replay), timed(replay), timed(eager)]
    out[kind] = {"g1": rows, "g2_kernels_in_one_replay": counts,
                              "g3_wall_ms": dict(zip(("eager", "graph", "graph_2",
                                             "eager_2"), turns)),
                     "g4_capture_memory": g.capture_memory,
                     "launches_per_replay": dict(g.launches_per_replay)}
    mem = g.capture_memory
    log(f"  (g1) {what} {kind} replay (width {g.width}) vs the eager step, "
        f"two steps (slot 3 inactive): logits max abs "
        f"{[r['logits_max_abs_diff'] for r in rows]}"
        f", cache sections equal {[r['exact'] for r in rows]}; (g2) kernel "
        f"nodes a replay launches, by name {counts}")
    log(f"  (g3) [{card}] step wall eager / graph / graph / eager: "
        + " / ".join(f"{x:.2f}" for x in turns) + " ms; (g4) capture: "
        f"allocated {mem['allocated_before'] / 2**30:.3f} -> "
        f"{mem['allocated_after'] / 2**30:.3f} GiB, reserved "
        f"{mem['reserved_before'] / 2**30:.3f} -> "
        f"{mem['reserved_after'] / 2**30:.3f} GiB")
    final = engine.graphs_snapshot()
    if any(x["compiles"] != 1 for x in final.values()):
        raise RuntimeError(f"{what}: the checks recaptured: {final}")
    log(f"  (g5) {what}: graphs {sorted(final)} captured once each, 0 "
        f"recaptures; {out['g5']['replays']} replays = "
        f"{out['g5']['decode_steps']} decode steps")
    return out


def contiguous_step_times(torch, engine) -> dict:
    """The decode replay over the batch cache as the graph checks left it
    (8 slots near ``GRAPH_LENGTHS``) and a ``CHUNK_TOKENS``-token
    ``prefill_chunk_step`` on a fresh single cache of the engine's layout
    (its index reset to 0 before each), each by ``event_ms``. The caller
    holds the engine's lock."""
    import numpy as np

    model, params, dev = engine.model, engine.params, engine.device
    g, b = engine._decode.fn, engine.sc.slots
    toks = np.arange(b, dtype=np.int32)
    decode_ms = event_ms(torch, lambda: g.run(params, engine._cache, toks,
                                              np.ones(b, bool)))
    single = engine._fresh_cache(1)
    ctoks = torch.arange(CHUNK_TOKENS, device=dev,
                         dtype=torch.int32)[None] % engine.cfg.vocab_size
    n = torch.tensor([CHUNK_TOKENS], dtype=torch.int32, device=dev)

    def chunk():
        single["index"].zero_()
        model.prefill_chunk_step(params, ctoks, single, n)

    chunk_ms = event_ms(torch, chunk, reps=5)
    del single
    return {"decode_replay_event_ms": decode_ms, "chunk_event_ms": chunk_ms,
            "chunk_tokens": CHUNK_TOKENS}


def ring_ignoring_logits(torch, engine, ctx: list[int]):
    """The final step of ``ctx`` rebuilt on a fresh single cache (head
    through ``prefill``, the rest through ``prefill_chunk_step``, the
    last token through ``decode_step``), as the engine computed it, and
    the same step with the ring's ``abs_pos`` replaced by the slot index
    (a ring that ignores which position each slot holds, the control).
    Returns (logits, control logits), the control None on a linear
    cache."""
    model, params, dev = engine.model, engine.params, engine.device
    single = engine._fresh_cache(1)
    head = ctx[:INTERLEAVE_CHUNK]
    model.prefill(params, torch.tensor([head], device=dev), single)
    rest = ctx[len(head):-1]
    for i in range(0, len(rest), INTERLEAVE_CHUNK):
        part = rest[i:i + INTERLEAVE_CHUNK]
        model.prefill_chunk_step(
            params, torch.tensor([part], device=dev), single,
            torch.tensor([len(part)], dtype=torch.int32, device=dev))
    last = torch.tensor([ctx[-1]], device=dev)
    if "abs_pos" not in single:
        good, _ = model.decode_step(params, last, single)
        return good[0], None
    broken = {k: v.clone() for k, v in single.items()}
    broken["abs_pos"].copy_(torch.arange(broken["abs_pos"].shape[1],
                                         device=dev)[None])
    good, _ = model.decode_step(params, last, single)
    bad, _ = model.decode_step(params, last, broken)
    return good[0], bad[0]


def long_run(torch, engine, cfg, n_prompt: int, n_decode: int, limit: float,
             what: str) -> dict:
    """One prompt of ``n_prompt`` tokens and ``n_decode`` greedy tokens
    through the engine, past its window and round its ring (or into a
    linear cache): the final step's logits (the decode graph's output
    when the last token was sampled) against ``interleave_logits`` over
    prompt + generated tokens, with every control of ``interleave_drops``
    and, on a ring, one that ignores ``abs_pos``
    (``ring_ignoring_logits``) outside the limit."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    prompt = [int(x) for x in rng.integers(0, cfg.vocab_size, n_prompt)]
    seen: dict = {"n": 0}

    def on_token(_tok):
        i = next(i for i, s in enumerate(engine._slots)
                 if s.request is not None)
        seen["n"] += 1
        logits = engine._decode.fn.logits
        if seen["n"] > 1 and logits is not None:
            seen["logits"] = logits[i].clone()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = engine.submit(prompt, max_new_tokens=n_decode,
                        on_token=on_token).result(timeout=900)
    wall = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    gen = res["tokens"]
    ctx = prompt + gen[:-1]
    ring = engine._ring_len
    where = (f"over a ring of {ring}, window {cfg.sliding_window}" if ring
             else f"in a linear cache of {engine.sc.cache_len}")
    log(f"  {what}: a {n_prompt}-token prompt + {len(gen)} greedy tokens in "
        f"{wall:.1f} s (TTFT {res['ttft_s'] * 1e3:.0f} ms); {len(ctx)} "
        f"positions {where}")
    with engine._prefix_lock:
        rebuilt, ignoring = ring_ignoring_logits(torch, engine, ctx)
        check = interleave_check(
            torch, cfg, engine.params, ctx, seen["logits"], limit,
            what + " final step",
            None if ignoring is None else {"ring_ignores_abs_pos": ignoring})
    check["rebuilt_vs_engine_rel_l2"] = (
        (rebuilt.float() - seen["logits"].float()).norm()
        / seen["logits"].float().norm()).item()
    return {"prompt_tokens": n_prompt, "generated": len(gen), "wall_s": wall,
            "ttft_ms": res["ttft_s"] * 1e3, "ring_len": ring,
            "serve_peak_bytes": serve_peak,
            "context_tokens": len(ctx), "check": check}


def interleave_engine_run(torch, dev, card: str, name: str, cache_len: int,
                          quant: bool, n_long: int, n_decode: int, params,
                          extra=()) -> dict:
    """One model through the engine the serve CLI builds (``--model
    <name>``, 8 slots, ``--serving-chunk-tokens 1024``, with ``quant``
    ``--int4 --kv-int8``, then ``extra``), which must serve from the
    contiguous loop: weight, cache and peak bytes; the burst with exact
    launches a step (``rms_norm`` 2, 4 or 6 a layer and once, ``int4_matmul``
    7 a layer under int4, no paged kernel, ``flash_fwd`` once a layer a
    prefill head); (g1)-(g5); the decode replay's and a chunk's time; the
    burst prompt's last-token logits through the engine's own prefill on a
    fresh cache against ``interleave_check``; and with ``n_long`` the long
    prompt past the window or into the linear cache (``long_run``)."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_fwd, int4_matmul,
                                                  paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    cfg = MODEL_CONFIGS[name]()
    argv = ["--model", name, "--device", dev.type, "--slots", "8",
            "--cache-len", str(cache_len), "--max-new-tokens", "32",
            "--serving-chunk-tokens", str(INTERLEAVE_CHUNK), *extra]
    if quant:
        argv += ["--int4", "--kv-int8"]
    what = f"{name} {'int4/int8' if quant else 'bf16'} contiguous engine"
    torch.cuda.reset_peak_memory_stats()
    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), params)
    limit = QUANT_ENGINE_REL_L2_LIMIT if quant else ENGINE_REL_L2_LIMIT
    try:
        snap = engine.debug_snapshot()
        interleave = cfg.sliding_window_pattern > 1
        layout = "mixed" if interleave else "linear"
        if snap["paged_decode"] or snap["cache_layout"] != layout:
            raise RuntimeError(f"{what}: paged_decode {snap['paged_decode']}"
                               f", cache {snap['cache_layout']}")
        n = cfg.n_layers
        norms = (2 + 2 * cfg.post_norms + 2 * cfg.qk_norm) * n + 1
        per_step = {"rms_norm": norms, "paged_attention_multi": 0,
                    "paged_attention_multi_quant": 0, "paged_attention": 0,
                    "paged_attention_quant": 0}
        kernels = [rms_norm, flash_fwd, paged_attention_multi,
                   paged_attention_multi_quant, paged_attention,
                   paged_attention_quant]
        if quant:
            per_step["int4_matmul"] = 7 * n + (0 if cfg.tie_embeddings
                                               else 1)
            kernels.append(int4_matmul)
        weight_bytes = tensor_bytes(engine.params)
        cache_bytes = tensor_bytes(engine._cache)
        log(f"  {what}: {n} layers, E={cfg.embed_dim}, heads {cfg.n_heads}/"
            f"{cfg.n_kv_heads} of {cfg.head_dim_}, windows "
            f"{cfg.layer_windows()}; cache {snap['cache_layout']} (ring "
            f"{snap['ring_len']}, cache_len {cache_len}) "
            + ", ".join(f"{k} {tuple(v.shape)}"
                        for k, v in engine._cache.items())
            + f"; weights {weight_bytes / 1e9:.3f} GB, cache "
            f"{cache_bytes / 1e9:.3f} GB; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; per "
            f"step {per_step}")
        torch.cuda.reset_peak_memory_stats()
        rec = contiguous_burst(torch, engine, cfg, card, tuple(kernels),
                               per_step, n)
        serve_peak = torch.cuda.max_memory_allocated()
        prompts = rec.pop("prompts")
        with engine._prefix_lock:
            rec["graphs"] = contiguous_graph_checks(torch, engine, card,
                                                    limit, what)
            rec["times"] = contiguous_step_times(torch, engine)
            single = engine._fresh_cache(1)
            logits, _ = engine.model.prefill(
                engine.params, torch.tensor([prompts[2]], device=dev),
                single)
            del single
            rec["reference"] = interleave_check(
                torch, cfg, engine.params, prompts[2], logits[0], limit,
                what)
        if n_long:
            rec["long"] = long_run(torch, engine, cfg, n_long, n_decode,
                                   limit, what)
        # serving only: the burst, and the long prompt before its checks
        # (their plain f32 forwards are not the engine's memory)
        serve_peak = max(serve_peak, rec.get("long", {}).get(
            "serve_peak_bytes", 0))
        rec.update(serve_peak_bytes=serve_peak,
                   weight_bytes=weight_bytes, cache_bytes=cache_bytes,
                   cache_layout=snap["cache_layout"],
                   ring_len=snap["ring_len"], cache_len=cache_len,
                   cache_shapes={k: list(v.shape)
                                 for k, v in engine._cache.items()})
        log(f"  [{card}] {what}: peak allocated while serving "
            f"{rec['serve_peak_bytes'] / 2**30:.2f} GiB; decode replay "
            f"{rec['times']['decode_replay_event_ms']:.3f} ms, "
            f"{CHUNK_TOKENS}-token chunk "
            f"{rec['times']['chunk_event_ms']:.3f} ms (between CUDA events)")
        return rec
    finally:
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 7g (e) and (f): speculation and a tensor mesh, contiguous loop --

def self_continued_tokens(torch, engine, first: int = 1024,
                          chunk: int = 1024) -> list:
    """Tokens t whose one-token context the engine's model continues with
    t itself, best margin first: [(t, margin of t over the runner-up)]. A
    context of t repeated holds the same V row at every position, so
    attention returns that row whatever the scores (windows and soft caps
    included), every position's hidden state is the one-token context's,
    and the greedy next token is t again for every length. The bf16
    forward over the first ``first`` ids, ``chunk`` at a time (further
    while fewer than two are found). On 7g's gemma2-9b tree the logits
    sit at the final soft cap, so the top two tie in bf16 (margin 0) and
    the streams fall into repeats of other tokens, whose drafts are
    accepted all the same (PERF.md §6)."""
    model, params, dev = engine.model, engine.params, engine.device
    vocab = engine.cfg.vocab_size
    found, start = [], 0
    while start < vocab and (start < first or len(found) < 2):
        ids = torch.arange(start, min(start + chunk, vocab), device=dev)
        logits = model.forward(params, ids[:, None], train=False)[:, 0]
        top2 = logits.float().topk(2, dim=-1)
        for i in (top2.indices[:, 0] == ids).nonzero().flatten().tolist():
            found.append((int(ids[i]), float(top2.values[i, 0]
                                             - top2.values[i, 1])))
        del logits, top2
        start += chunk
    return sorted(found, key=lambda tm: -tm[1])


def spec7g_traffic(torch, engine, cfg) -> dict:
    """(e)'s and (f)'s traffic (phase 7s's kind): two prompts repeating a
    token the model continues with itself (``self_continued_tokens``;
    their drafts are accepted), phase 4's first four prompts (drafts
    rejected) and one prompt past the 5120-slot ring."""
    import numpy as np

    rng = np.random.default_rng(SEED + 40)
    _, burst, _ = burst_prompts(cfg)
    t0 = time.perf_counter()
    with engine._prefix_lock:
        fixed = self_continued_tokens(torch, engine)
    sweep_s = time.perf_counter() - t0
    tokens = [t for t, _ in fixed[:2]]
    while len(tokens) < 2:
        tokens.append(int(rng.integers(0, cfg.vocab_size)))
    rep = [[t] * n for t, n in zip(tokens, SPEC7G_REPEATS)]
    long_prompt = [int(x) for x in rng.integers(0, cfg.vocab_size,
                                                SPEC7G_RING_PROMPT)]
    return {"prompts": rep + burst[:4] + [long_prompt],
            "repeated_tokens": tokens, "self_continued": fixed[:8],
            "sweep_s": sweep_s}


def spec7g_run(torch, engine, prompts, kernels, per_call,
               flash_per_head: int, what: str) -> dict:
    """``prompts`` through one engine at once (7 requests on 8 slots),
    ``SPEC7G_NEW`` greedy tokens each. Launch counts are set to 0 just
    before and read just after: each kernel of ``per_call`` launches that
    many times a decode or verify step or prefill call (a head or a
    chunk), ``flash_fwd`` ``flash_per_head`` times a head; every step is
    one graph replay."""
    from k8s_runpod_kubelet_tpu_torch.ops import flash_fwd

    names = ("dense_prefill_heads", "dense_prefill_chunks", "decode_steps",
             "spec_proposed", "spec_accepted")

    def snap() -> dict:
        with engine._prefix_lock:
            return {**{k: engine.counters[k] for k in names},
                    "replays": sum(g.fn.replays for g in engine._graphs()),
                    **{k.__name__: k.launches for k in kernels}}

    with engine._prefix_lock:
        for k in kernels:
            k.launches = 0
    s0 = snap()
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens=SPEC7G_NEW) for p in prompts]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    s1 = snap()
    d = {k: s1[k] - s0[k] for k in s0}
    calls = (d["dense_prefill_heads"] + d["dense_prefill_chunks"]
             + d["decode_steps"])
    if d["replays"] != d["decode_steps"]:
        raise RuntimeError(f"{what}: {d['replays']} graph replays for "
                           f"{d['decode_steps']} decode steps")
    want = {name: n * calls for name, n in per_call.items()}
    want[flash_fwd.__name__] = flash_per_head * d["dense_prefill_heads"]
    for name, need in want.items():
        if d[name] != need or (per_call.get(name) and d[name] < 1):
            raise RuntimeError(
                f"{what}: {name} launched {d[name]} times in "
                f"{d['dense_prefill_heads']} heads, "
                f"{d['dense_prefill_chunks']} chunks and "
                f"{d['decode_steps']} steps, not {need}")
    if any(len(r["tokens"]) != SPEC7G_NEW for r in results):
        raise RuntimeError(f"{what}: not every request finished with "
                           f"{SPEC7G_NEW} tokens")
    log(f"  {what}: {len(prompts)} requests "
        f"({sum(len(p) for p in prompts)} prompt tokens) in {wall:.2f} s; "
        f"{d['dense_prefill_heads']} prefill heads, "
        f"{d['dense_prefill_chunks']} chunks, {d['decode_steps']} steps "
        f"(= replays); drafts proposed {d['spec_proposed']}, accepted "
        f"{d['spec_accepted']}; launches "
        + str({k.__name__: d[k.__name__] for k in kernels}))
    return {"tokens": [r["tokens"] for r in results], "counts": d,
            "wall_s": wall, "ttft_ms": [r["ttft_s"] * 1e3 for r in results]}


def shard_swap_logits(torch, engine, prompt: list[int]):
    """The last token of ``prompt`` through a tensor-parallel engine's own
    steps on a fresh single cache (the rest through ``prefill``), and the
    same step with shard 1's kv heads overwritten by shard 0's (shard 1's
    q heads attend shard 0's kv heads, the control). Returns (logits,
    control logits)."""
    model, params, dev = engine.model, engine.params, engine.device
    n = engine.model.cache_head_shards
    single = engine._fresh_cache(1)
    model.prefill(params, torch.tensor([prompt[:-1]], device=dev), single)
    broken = {k: v.clone() for k, v in single.items()}
    for name, t in broken.items():
        if name not in ("index", "abs_pos"):
            shards = t.view(n, -1, *t.shape[1:])
            shards[1].copy_(shards[0])
    last = torch.tensor([prompt[-1]], device=dev)
    good, _ = model.decode_step(params, last, single)
    bad, _ = model.decode_step(params, last, broken)
    return good[0], bad[0]


def contiguous_spec_tp_phase(torch, dev, card: str, params) -> dict:
    """Phase 7g (e) and (f) on 7g's gemma2-9b bf16 tree ``params``,
    through the engines the serve CLI builds (8 slots, cache_len 8192,
    1024-token chunks) on one traffic (``spec7g_traffic``): 7g's plain
    engine, then (e) ``--speculate 4`` (greedy tokens equal to the plain
    engine's up to a first divergence at a near tie, drafts accepted and
    rejected, launches exact a call, (g1)-(g5) on the verify graph, the
    verify and decode replays' times), then (f) ``--tensor-parallel 2`` in
    one process over a shallow copy of the tree (tokens held likewise,
    ``flash_fwd`` twice a layer a prefill head, the last-token logits
    within 0.1 of ``interleave_logits`` and a control whose shard 1
    attends shard 0's kv heads outside it, weight, cache and peak bytes,
    the decode replay's time)."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_fwd, paged_attention,
                                                  paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  paged_attention_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    cfg = MODEL_CONFIGS["gemma2-9b"]()
    n_layers = cfg.n_layers
    argv = ["--model", "gemma2-9b", "--device", dev.type, "--slots", "8",
            "--cache-len", "8192", "--max-new-tokens", str(SPEC7G_NEW),
            "--serving-chunk-tokens", str(INTERLEAVE_CHUNK)]
    norms = (2 + 2 * cfg.post_norms + 2 * cfg.qk_norm) * n_layers + 1
    per_call = {"rms_norm": norms, "paged_attention_multi": 0,
                "paged_attention_multi_quant": 0, "paged_attention": 0,
                "paged_attention_quant": 0}
    kernels = (rms_norm, flash_fwd, paged_attention_multi,
               paged_attention_multi_quant, paged_attention,
               paged_attention_quant)
    limit = ENGINE_REL_L2_LIMIT

    def build(extra, tree=params):
        return serve_main.build_engine(serve_main.parse_args(argv + extra),
                                       tree)[0]

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    out: dict = {}
    log(f"phase 7g (e): gemma2-9b bf16 --speculate {SPEC7G_K} on the "
        "contiguous loop (the K + 1 verify graph over the mixed cache), "
        "after the plain engine on the same traffic")
    engine = build([])
    try:
        traffic = spec7g_traffic(torch, engine, cfg)
        prompts = traffic["prompts"]
        log(f"  self-continued tokens {traffic['self_continued'][:4]} (a "
            f"{traffic['sweep_s']:.1f} s sweep); repeated "
            f"{traffic['repeated_tokens']}; prompts "
            f"{[len(p) for p in prompts]}")
        plain = spec7g_run(torch, engine, prompts, kernels, per_call,
                           n_layers, "gemma2-9b plain contiguous engine")
    finally:
        engine.stop()
        engine = None
        freed()
    out["traffic"] = {k: v for k, v in traffic.items() if k != "prompts"}
    out["traffic"]["prompt_lengths"] = [len(p) for p in prompts]
    out["plain"] = plain
    engine = build(["--speculate", str(SPEC7G_K)])
    what = f"gemma2-9b --speculate {SPEC7G_K} contiguous engine"
    try:
        snap = engine.debug_snapshot()
        if (snap["paged_decode"] or snap["cache_layout"] != "mixed"
                or sorted(snap["graphs"]) != ["decode", "verify"]):
            raise RuntimeError(f"{what}: paged_decode "
                               f"{snap['paged_decode']}, cache "
                               f"{snap['cache_layout']}, graphs "
                               f"{sorted(snap['graphs'])}")
        spec = spec7g_run(torch, engine, prompts, kernels, per_call,
                          n_layers, what)
        c = spec["counts"]
        if not 0 < c["spec_accepted"] < c["spec_proposed"]:
            raise RuntimeError(f"{what}: drafts accepted {c['spec_accepted']}"
                               f" of {c['spec_proposed']}: both kinds needed")
        div = divergence_check(torch, cfg, params, prompts, spec["tokens"],
                               plain["tokens"], reference=interleave_logits)
        log(f"  (b) divergences from the plain engine: {div['count']} "
            + str([(d["at"], round(d["margin_share"], 3))
                   for d in div["divergences"]])
            + f" (tie margin {SPEC_TIE_MARGIN})")
        with engine._prefix_lock:
            graphs = contiguous_graph_checks(torch, engine, card, limit,
                                             what, verify=True)
            if not all(r["exact"] for r in graphs["verify"]["g1"]):
                raise RuntimeError(f"{what}: the verify replay is not the "
                                   f"eager step bit for bit: "
                                   f"{graphs['verify']['g1']}")
            per_replay = engine._verify.fn.launches_per_replay
            if {k: per_replay[k] for k in per_call} != per_call:
                raise RuntimeError(f"{what}: the verify graph launches "
                                   f"{per_replay}, not {per_call}")
            g_dec, g_ver = engine._decode.fn, engine._verify.fn
            b = engine.sc.slots
            ones = np.ones(b, bool)
            decode_ms = event_ms(torch, lambda: g_dec.run(
                engine.params, engine._cache, np.arange(b, dtype=np.int32),
                ones))
            verify_ms = event_ms(torch, lambda: g_ver.run(
                engine.params, engine._cache,
                np.zeros((b, SPEC7G_K + 1), np.int32), ones))
        log(f"  [{card}] {what}: verify replay (K + 1 = {SPEC7G_K + 1}) "
            f"{verify_ms:.3f} ms, decode replay {decode_ms:.3f} ms "
            f"(between CUDA events, 8 slots near {list(GRAPH_LENGTHS)})")
        out["spec"] = dict(spec, divergence=div, graphs=graphs,
                           verify_launches_per_replay=dict(per_replay),
                           verify_replay_event_ms=verify_ms,
                           decode_replay_event_ms=decode_ms)
    finally:
        engine.stop()
        engine = None
        freed()

    log(f"phase 7g (f): gemma2-9b bf16 at --tensor-parallel {TP7G} in one "
        "process on the contiguous loop (head-sharded mixed cache)")
    ref_prompt = prompts[4]
    ref = interleave_logits(torch, cfg, params, ref_prompt)
    torch.cuda.reset_peak_memory_stats()
    # a shallow copy: the engine lays its leaves out over the shards in
    # place, and the divergence references read the one-device tree
    engine = build(["--tensor-parallel", str(TP7G)],
                   {k: dict(v) if isinstance(v, dict) else v
                    for k, v in params.items()})
    what = f"gemma2-9b --tensor-parallel {TP7G} contiguous engine"
    try:
        snap = engine.debug_snapshot()
        if (snap["paged_decode"] or snap["tensor_parallel"] != TP7G
                or snap["cache_head_shards"] != TP7G
                or snap["paged_tp_shards"] != 0):
            raise RuntimeError(f"{what}: {snap['paged_decode']=}, "
                               f"{snap['tensor_parallel']=}, "
                               f"{snap['cache_head_shards']=}, "
                               f"{snap['paged_tp_shards']=}")
        weight_bytes = tensor_bytes(engine.params)
        cache_bytes = tensor_bytes(engine._cache)
        log(f"  {what}: cache " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in engine._cache.items())
            + f"; weights {weight_bytes / 1e9:.3f} GB, cache "
            f"{cache_bytes / 1e9:.3f} GB; [{card}] "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
            "(the one-device tree kept beside the shards)")
        tp = spec7g_run(torch, engine, prompts, kernels, per_call,
                        TP7G * n_layers, what)
        serve_peak = torch.cuda.max_memory_allocated()
        div = divergence_check(torch, cfg, params, prompts, tp["tokens"],
                               plain["tokens"], reference=interleave_logits)
        log(f"  divergences from the tensor-1 engine: {div['count']} "
            + str([(d["at"], round(d["margin_share"], 3))
                   for d in div["divergences"]]))
        with engine._prefix_lock:
            logits, control = shard_swap_logits(torch, engine, ref_prompt)

            def rel(a):
                return ((a.float() - ref).norm() / ref.norm()).item()

            check = {"tokens": len(ref_prompt), "rel_l2": rel(logits),
                     "limit_rel_l2": limit,
                     "argmax_agree": bool(logits.argmax() == ref.argmax()),
                     "controls_rel_l2": {"shard1_reads_shard0_kv":
                                         rel(control)}}
            g_dec = engine._decode.fn
            b = engine.sc.slots
            decode_ms = event_ms(torch, lambda: g_dec.run(
                engine.params, engine._cache, np.arange(b, dtype=np.int32),
                np.ones(b, bool)))
        log(f"  independent check: {what} vs the plain f32 forward, "
            f"last-token logits over {len(ref_prompt)} tokens: relative L2 "
            f"{check['rel_l2']:.4f} (limit {limit}), argmax agree "
            f"{check['argmax_agree']}; control shard 1 reading shard 0's kv "
            f"heads {check['controls_rel_l2']['shard1_reads_shard0_kv']:.4f}")
        if not check["rel_l2"] <= limit:
            raise RuntimeError(f"{what} logits off the plain forward: {check}")
        if not check["controls_rel_l2"]["shard1_reads_shard0_kv"] > limit:
            raise RuntimeError(f"{what}: the shard-swap control passed: "
                               f"{check}")
        log(f"  [{card}] {what}: peak allocated while serving "
            f"{serve_peak / 2**30:.2f} GiB; decode replay {decode_ms:.3f} ms "
            "(between CUDA events)")
        out["tp"] = dict(tp, divergence=div, check=check,
                         weight_bytes=weight_bytes, cache_bytes=cache_bytes,
                         serve_peak_bytes=serve_peak,
                         cache_shapes={k: list(v.shape) for k, v in
                                       engine._cache.items()},
                         decode_replay_event_ms=decode_ms)
    finally:
        engine.stop()
        engine = None
        freed()
    return out


def draw_interleave_tree(torch, dev, name: str, i: int):
    """Phase 7g's bf16 tree of ``name`` for its ``INTERLEAVE_RUNS`` entry
    ``i``: drawn from the seed with its branches away from identity
    (``draw_family_branches``) and, under a final soft cap, the final norm
    raised by ``SOFTCAP_FINAL_NORM``."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS, init_params

    cfg = MODEL_CONFIGS[name]()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 200 + i), dev)
    draw_family_branches(torch, cfg, params, SEED + 300 + i)
    if cfg.logit_softcap:
        # the final norm at (1 + w) ~ 1 + SOFTCAP_FINAL_NORM, so the tied
        # head's logits reach the cap and the cap bites
        params["final_norm"].add_(SOFTCAP_FINAL_NORM)
    torch.cuda.synchronize()
    return params


def interleave_phase(torch, dev, card: str) -> dict:
    """Phase 7g: ``INTERLEAVE_RUNS``, one model at a time at full width and
    depth, bf16 weights from the seed with their norms (the sandwich norms
    and the q/k norm among them) drawn away from identity
    (``draw_family_branches``); gemma3-12b's int4 engine quantizes the
    same tree. After gemma2-9b's bf16 run, (e) and (f) on its tree
    (``contiguous_spec_tp_phase``)."""
    out: dict = {}
    params, drawn = None, None
    for i, (name, cache_len, quant, n_long, n_decode) in enumerate(
            INTERLEAVE_RUNS):
        if drawn != name:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            params = draw_interleave_tree(torch, dev, name, i)
            drawn = name
            log(f"phase 7g: {name} (bf16, branches drawn away from identity;"
                f" drawn in {time.perf_counter() - t0:.1f} s)")
        key = name.replace("-", "_") + ("_int4_kv_int8" if quant else "")
        log(f"phase 7g: {key} (cache_len {cache_len}, a {n_long}-token "
            f"prompt past the window)")
        out[key] = interleave_engine_run(torch, dev, card, name, cache_len,
                                         quant, n_long, n_decode, params)
        if name == "gemma2-9b" and not quant:
            out["gemma2_9b_spec_tp"] = contiguous_spec_tp_phase(
                torch, dev, card, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def qk_witness_phase(torch, dev, card: str) -> dict:
    """``--qk-witness``: how far bf16 roundings alone move gemma3-12b as
    its attention sharpens. The model is drawn as phase 7g draws it, its
    q/k norm applied at U(lo, lo + 1) for each lo of ``QK_WITNESS_LOWS``
    (0.5 is phase 7g's draw; the same uniform numbers each time, so only
    the scale moves). For each, the last-token logits of the burst prompt
    phase 7g checks, through three bf16 paths, against the plain f32
    forward (``interleave_logits``): the engine's ``prefill`` (the flash
    kernel) and ``prefill_chunk_step`` from an empty cache (the plain
    attention of the contiguous steps) on a mixed cache of phase 7g's
    shape, and a plain bf16 forward that shares no code with the model's
    steps (``interleave_logits`` with ``rounding``). Where the plain bf16
    forward misses by as much as the model's paths, the miss is rounding
    that sharper attention amplifies, not a fault of the steps."""
    from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel,
                                                     MODEL_CONFIGS,
                                                     init_params)

    name, cache_len, ring = "gemma3-12b", 4096, 2048
    i = next(j for j, run in enumerate(INTERLEAVE_RUNS) if run[0] == name)
    cfg = MODEL_CONFIGS[name]()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 200 + i), dev)
    model = LlamaModel(cfg, dev)
    tokens = burst_prompts(cfg)[1][2]
    toks = torch.tensor([tokens], device=dev)
    out = {"model": name, "tokens": len(tokens), "card": card, "lows": {}}
    for lo in QK_WITNESS_LOWS:
        draw_family_branches(torch, cfg, params, SEED + 300 + i, qk_low=lo)
        ref = interleave_logits(torch, cfg, params, tokens)

        def rel(a, b=ref):
            return ((a.float() - b).norm() / b.norm()).item()

        flash, _ = model.prefill(params, toks,
                                 model.init_mixed_cache(1, cache_len, ring))
        chunk, _ = model.prefill_chunk_step(
            params, toks, model.init_mixed_cache(1, cache_len, ring),
            torch.tensor([len(tokens)], dtype=torch.int32, device=dev))
        plain = interleave_logits(torch, cfg, params, tokens,
                                  rounding=torch.bfloat16)
        row = {"prefill_flash": rel(flash[0]),
               "chunk_step_plain_attention": rel(chunk[0]),
               "plain_bf16_forward": rel(plain),
               "layer_control": rel(interleave_logits(
                   torch, cfg, params, tokens, ("layer",))),
               "prefill_vs_plain_bf16": rel(flash[0], plain.float()),
               "argmax_agree": [bool(a.argmax() == ref.argmax())
                                for a in (flash[0], chunk[0], plain)]}
        out["lows"][lo] = row
        log(f"  q/k norm applied at U({lo}, {lo + 1}): relative L2 off the "
            f"f32 forward over {len(tokens)} tokens: prefill (flash) "
            f"{row['prefill_flash']:.4f}, chunk step (plain attention) "
            f"{row['chunk_step_plain_attention']:.4f}, plain bf16 forward "
            f"{row['plain_bf16_forward']:.4f}; the middle layer skipped "
            f"{row['layer_control']:.4f}; prefill vs the plain bf16 "
            f"forward {row['prefill_vs_plain_bf16']:.4f}; argmax agree "
            f"{row['argmax_agree']}")
        del flash, chunk, plain, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 7k: disaggregated serving (the KV handoff between replicas) -------

# the decode replicas' greedy tokens a request
DISAGG_NEW = 16
# a prefill replica's chunk and its stream window (serve_main's flags)
DISAGG_CHUNK = 256
DISAGG_WINDOW = 8
# the placement domain every replica of the phase advertises
DISAGG_DOMAIN = "card:0"
# arenas: 2 slots of 2048 tokens need 256 pages of 16 tokens; the owner
# process of (d) holds exactly that, so five 900-token fillers evict a run
DISAGG_SLOTS = 2
DISAGG_POOL = 512
DISAGG_OWNER_POOL = 256
# (f): the timed runs' prompt length (64 pages)
DISAGG_TIMED_TOKENS = 1024
# seconds a serve_main process may take to answer /readyz
DISAGG_READY_S = 420
# the serve_main processes' model (phase 4's)
DISAGG_REPLICA_ARGS = ("--model", "llama3-8b")


def disagg_engine(torch, dev, cfg, params, chunk: int = 0, kv_int8=False):
    """An engine of the phase on the shared ``params`` (a bf16 tree is not
    copied: the engines read one set of weights)."""
    from k8s_runpod_kubelet_tpu_torch.workloads.serving import (
        ServingConfig, ServingEngine)
    sc = ServingConfig(slots=DISAGG_SLOTS, cache_len=2048,
                       max_prefill_len=1024, kv_page_tokens=16,
                       max_new_tokens=DISAGG_NEW, kv_pool_pages=DISAGG_POOL,
                       serving_chunk_tokens=chunk, quantize_kv_int8=kv_int8)
    return ServingEngine(cfg, params, sc, device=dev).start()


def greedy(engine, prompt, n: int = DISAGG_NEW) -> list:
    return engine.submit(prompt, max_new_tokens=n).result(
        timeout=900)["tokens"]


def unified_tokens(engine, prompt) -> list:
    """A unified engine's tokens along a decode replica's path: the prompt
    once (its full pages cached), then again from the cached pages and the
    sub-page tail, as the decode replica serves an adopted run."""
    greedy(engine, prompt, 1)
    return greedy(engine, prompt)


def cached_run(engine, prompt) -> dict:
    """Fresh copies of every cached full page of ``prompt`` in engine's
    arena (single-device layout)."""
    store = engine._kv_store
    with engine._prefix_lock:
        m = store.match_full(0, prompt)
        try:
            return store.export_pages(m.pages)
        finally:
            store.release(m.pages)


def same_pages(torch, a, b, prompt, what: str) -> int:
    """Raise unless ``a``'s cached pages of ``prompt`` equal ``b``'s bit for
    bit; returns the pages compared."""
    ra, rb = cached_run(a, prompt), cached_run(b, prompt)
    n = len(prompt) // 16
    for name in ra:
        if ra[name].shape[1] != n or not torch.equal(ra[name], rb[name]):
            raise RuntimeError(f"{what}: adopted section {name} differs from "
                               "the exporter's pages")
    return n


def http_get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=300) as r:
        return json.loads(r.read())


def decode_hop_checks(counts_before: dict, counts_after: dict, prompt,
                      got: list, want: list, what: str) -> None:
    """The decode replica's request after an adoption: its tokens are the
    unified engine's and it prefilled one chunk, the sub-page tail."""
    if got != want:
        raise RuntimeError(f"{what}: decode replica tokens {got} != the "
                           f"unified engine's {want}")
    chunks = (counts_after["paged_prefill_chunks"]
              - counts_before["paged_prefill_chunks"])
    tail = (counts_after["paged_prefill_tokens"]
            - counts_before["paged_prefill_tokens"])
    if chunks != 1 or tail != len(prompt) - (len(prompt) - 1) // 16 * 16:
        raise RuntimeError(f"{what}: the decode replica prefilled {chunks} "
                           f"chunks, {tail} tokens; want the tail alone")


def start_replica(port: int, role: str, pool: int, log_path: str):
    """A ``serve_main`` process on the card: llama3-8b bf16 from the
    phase's seed (phase 4's weights), 2 slots, in the phase's domain."""
    cmd = [sys.executable, "-m",
           "k8s_runpod_kubelet_tpu_torch.workloads.serve_main",
           *DISAGG_REPLICA_ARGS, "--slots", str(DISAGG_SLOTS),
           "--cache-len", "2048", "--max-new-tokens", str(DISAGG_NEW),
           "--seed", str(SEED), "--kv-pool-pages", str(pool),
           "--port", str(port), "--serving-role", role,
           "--placement-domain", DISAGG_DOMAIN,
           "--fleet-advertise", f"http://127.0.0.1:{port}"]
    out = open(log_path, "w")
    return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def wait_ready(proc, port: int, log_path: str) -> None:
    deadline = time.monotonic() + DISAGG_READY_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"serve_main on :{port} exited "
                               f"{proc.returncode}:\n{tail}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                        timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.5)
    raise RuntimeError(f"serve_main on :{port} not ready in "
                       f"{DISAGG_READY_S} s")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def counters_of(port: int) -> dict:
    return http_get_json(port, "/debug/engine")["counters"]


def pool_of(port: int) -> dict:
    stats = http_get_json(port, "/debug/engine")["prefix_cache"]
    return {k: stats[k] for k in ("pages_free", "pages_shared",
                                  "pages_evictable", "nodes")}


def sink_server():
    """An HTTP server that reads a POST body and answers: the wire rung's
    transfer, timed without the adoption behind it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Sink(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(n)
            body = b"{}"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def rung_times(torch, src, dst, prompts, card: str) -> dict:
    """(f): export, transfer and adopt ms a page and bytes a second for
    each rung, on runs of ``DISAGG_TIMED_TOKENS`` the exporter already
    holds and the adopter does not (one prompt a rung)."""
    from k8s_runpod_kubelet_tpu_torch.fleet.device_transfer import (
        open_shm_blob, write_shm_blob)
    sink = sink_server()
    out = {}
    try:
        for rung, prompt in zip(("device", "shm", "wire"), prompts):
            greedy(src, prompt, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rung == "device":
                exp = src.export_pull_device(prompt)
                nbytes = exp["bytes"]
            else:
                exp = src.export_pull(prompt)
                nbytes = len(exp["blob"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if rung == "shm":
                path = write_shm_blob(exp["blob"])
                blob = open_shm_blob(path)
            elif rung == "wire":
                req = urllib.request.Request(
                    f"http://127.0.0.1:{sink.server_address[1]}/",
                    data=exp["blob"], method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    r.read()
                blob = exp["blob"]
            t2 = time.perf_counter()
            if rung == "device":
                dst.adopt_handoff_device(exp["tokens"], exp["sections"],
                                         model=src.cfg.name,
                                         ready=exp["ready"])
            else:
                dst.adopt_handoff(blob)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if rung == "shm":
                blob.close()
                os.unlink(path)
            pages = exp["pages"]
            out[rung] = {"pages": pages, "bytes": nbytes,
                         "export_ms_per_page": (t1 - t0) * 1e3 / pages,
                         "transfer_ms_per_page": (t2 - t1) * 1e3 / pages,
                         "adopt_ms_per_page": (t3 - t2) * 1e3 / pages,
                         "bytes_per_s": nbytes / (t3 - t0)}
            r = out[rung]
            log(f"  (f) [{card}] {rung}: {pages} pages, {nbytes} B; export "
                f"{r['export_ms_per_page']:.4f} ms a page, transfer "
                f"{r['transfer_ms_per_page']:.4f}, adopt "
                f"{r['adopt_ms_per_page']:.4f}; {r['bytes_per_s'] / 1e9:.3f} "
                "GB/s end to end")
    finally:
        sink.shutdown()
        sink.server_close()
    return out


def disagg_phase(torch, dev, card: str, cfg, params) -> dict:
    """Phase 7k: disaggregated serving of llama3-8b bf16 (phase 4's tree),
    the router's two hops played by hand (``fleet/router.py``'s
    ``plan_two_hop``: /kv_prefill on the prefill replica naming the decode
    replica, then the request on the decode replica) and its pull
    (/kv_fetch on the cold replica naming the owner). Unified engines on
    the same weights serve every prompt first, twice (the second from its
    cached pages and the tail: the decode replica's path), for the
    reference tokens. (a) the device rung between engines of this
    process behind ``serve_main.serve`` fronts, the decode engine on the
    device bus: monolithic and streamed (256-token chunks, window 8) hops
    of phase 4's burst prompts, each with the pages adopted equal to the
    exporter's bit for bit, the decode replica's tokens equal to the
    unified engine's after prefilling only the sub-page tail, the device
    runs counted and 0 downgrades; the kernels' launches over these hops
    and requests (counts at 0 just before); (b) the wire rung between two
    ``serve_main`` processes on the card (a prefill and a decode replica,
    phase 4's seed): /kv_prefill -> /kv_adopt, and a streamed hop from
    this process's chunked replica -> /kv_adopt_chunk, tokens equal to the
    unified engine's, /metrics deltas equal to the hops' counts, a
    truncated blob answered 400 with the decode arena's pool unchanged;
    (c) the shm rung between the same processes (the router vouching the
    shared domain): "path": "shm", 0 downgrades; (d) a pull: the decode
    process fetches a run the prefill process served from its /kv_pull
    and prefills only the tail; after fillers evicted another run, the
    owner answers 404 gone, the fetch 200 gone, and the request prefills
    whole to the unified engine's cold tokens; (e) --kv-int8 through the
    wire rung in this process, ``section_spec`` equal on both sides; (f)
    export, transfer and adopt ms a page and bytes a second a rung, and
    the time to first token of a two-hop request against a unified one,
    for the record."""
    from k8s_runpod_kubelet_tpu_torch.fleet.device_transfer import BUS
    from k8s_runpod_kubelet_tpu_torch.ops import (paged_attention_multi,
                                                  paged_attention_multi_quant,
                                                  rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    kernels = (paged_attention_multi, paged_attention_multi_quant, rms_norm)
    _, prompts, gen = burst_prompts(cfg)
    cold_prompt = gen(700)
    rec = {"domain": DISAGG_DOMAIN}
    t_phase = time.perf_counter()
    # the references: the unified engines serve every prompt first
    refs = {}
    for chunk, idx in ((0, (0, 1, 4, 6, 7)), (DISAGG_CHUNK, (2, 3, 5))):
        uni = disagg_engine(torch, dev, cfg, params, chunk)
        try:
            if chunk == 0:
                refs["cold"] = greedy(uni, cold_prompt)
            for i in idx:
                refs[i] = unified_tokens(uni, prompts[i])
        finally:
            uni.stop()
        del uni
    gc.collect()
    torch.cuda.empty_cache()

    pre = disagg_engine(torch, dev, cfg, params)
    pre_s = disagg_engine(torch, dev, cfg, params, DISAGG_CHUNK)
    dec = disagg_engine(torch, dev, cfg, params)
    fronts = [serve_main.serve(e, 0, host="127.0.0.1",
                               handoff_stream_window=DISAGG_WINDOW,
                               device_domain=DISAGG_DOMAIN)
              for e in (pre, pre_s, dec)]
    ports = [f.server_address[1] for f in fronts]
    dec_url = f"http://127.0.0.1:{ports[2]}"
    BUS.register(dec_url, dec, DISAGG_DOMAIN)
    procs = []
    try:
        log("  (a) the device rung: engines of this process, "
            f"{DISAGG_SLOTS} slots, {DISAGG_POOL}-page arenas")
        for k in kernels:
            k.launches = 0
        hops = []
        for i, port, streamed in ((0, ports[0], False), (1, ports[0], False),
                                  (2, ports[1], True), (3, ports[1], True)):
            src = pre_s if streamed else pre
            p = prompts[i]
            runs0 = dec.metrics.get_counter(
                "tpu_serving_kv_handoff_device_runs")
            out = http_ok(port, "/kv_prefill", {
                "request": {"tokens": p}, "handoff_to": dec_url,
                "device": True, "device_domain": DISAGG_DOMAIN})
            if (out["path"], out["streamed"]) != ("device", streamed):
                raise RuntimeError(f"(a) prompt {i}: hop {out}")
            pages = same_pages(torch, dec, src, p, f"(a) prompt {i}")
            c0 = dict(dec.counters)
            got = greedy(dec, p)
            decode_hop_checks(c0, dict(dec.counters), p, got, refs[i],
                              f"(a) prompt {i}")
            if dec.metrics.get_counter(
                    "tpu_serving_kv_handoff_device_runs") - runs0 != 1:
                raise RuntimeError(f"(a) prompt {i}: device runs not 1")
            hops.append({"prompt": i, "tokens": len(p), "pages": pages,
                         "streamed": streamed, "chunks": out.get("chunks"),
                         "bytes": out["bytes"]})
        downgrades = sum(e.metrics.get_counter(
            "tpu_serving_kv_handoff_device_downgrades") for e in (pre, pre_s))
        if downgrades:
            raise RuntimeError(f"(a) {downgrades} device downgrades")
        launches = {k.__name__: k.launches for k in kernels}
        if dev.type == "cuda" and not (launches["paged_attention_multi"]
                                       and launches["rms_norm"]):
            raise RuntimeError(f"(a) the handoff path launched {launches}")
        rec["device"] = {"hops": hops, "launches": launches,
                         "downgrades": downgrades}
        log(f"  (a) {len(hops)} hops (2 monolithic, 2 streamed in "
            f"{DISAGG_CHUNK}-token chunks): pages bit-equal, tokens equal "
            f"to the unified engine's, the tail alone prefilled, 0 "
            f"downgrades; launches {launches}")

        log("  (b)-(d) two serve_main processes on the card (prefill, "
            "decode), llama3-8b bf16 from the seed")
        tmp = tempfile.mkdtemp(prefix="disagg-")
        pport, dport = free_port(), free_port()
        for port, role, pool in ((pport, "prefill", DISAGG_OWNER_POOL),
                                 (dport, "decode", DISAGG_POOL)):
            log_path = os.path.join(tmp, f"{role}.log")
            procs.append((start_replica(port, role, pool, log_path), port,
                          log_path))
        for proc, port, log_path in procs:
            wait_ready(proc, port, log_path)
        p_url, d_url = f"http://127.0.0.1:{pport}", f"http://127.0.0.1:{dport}"
        rec["processes_ready_s"] = time.perf_counter() - t_phase

        def process_hop(src_port, i, what, **extra):
            m0, c0 = scrape(dport), counters_of(dport)
            out = http_ok(src_port, "/kv_prefill", {
                "request": {"tokens": prompts[i]}, "handoff_to": d_url,
                **extra})
            m1, c1 = scrape(dport), counters_of(dport)
            got = http_ok(dport, "/generate", {
                "tokens": prompts[i], "max_new_tokens": DISAGG_NEW})["tokens"]
            decode_hop_checks(c1, counters_of(dport), prompts[i], got,
                              refs[i], what)
            dpages = m1["tpu_serving_kv_handoff_pages_total"] \
                - m0["tpu_serving_kv_handoff_pages_total"]
            dbytes = m1["tpu_serving_kv_handoff_bytes_total"] \
                - m0["tpu_serving_kv_handoff_bytes_total"]
            if dpages != out["pages"] or (out["path"] == "wire"
                                          and dbytes != out["bytes"]):
                raise RuntimeError(f"{what}: /metrics moved {dpages} pages, "
                                   f"{dbytes} B; the hop said {out}")
            if c1["prefix_cache_hits"] != c0["prefix_cache_hits"]:
                raise RuntimeError(f"{what}: an adoption counted a hit")
            return {"prompt": i, "path": out["path"],
                    "streamed": bool(out.get("streamed")),
                    "pages": out["pages"], "bytes": out["bytes"]}

        wire = [process_hop(pport, 4, "(b) wire"),
                process_hop(ports[1], 5, "(b) wire streamed")]
        if [(h["path"], h["streamed"]) for h in wire] != \
                [("wire", False), ("wire", True)]:
            raise RuntimeError(f"(b) hops took {wire}")
        blob = pre.export_handoff(prompts[0])["blob"]
        pool0 = pool_of(dport)
        fail0 = scrape(dport)["tpu_serving_kv_handoff_failures_total"]
        status, _ = http_post_bytes(dport, "/kv_adopt", blob[:len(blob) // 2])
        if status != 400 or pool_of(dport) != pool0 or \
                scrape(dport)["tpu_serving_kv_handoff_failures_total"] \
                != fail0 + 1:
            raise RuntimeError(f"(b) a truncated blob answered {status}; "
                               f"pool {pool0} -> {pool_of(dport)}")
        rec["wire"] = {"hops": wire, "truncated_status": status}
        log(f"  (b) wire: {wire}; a truncated blob -> 400, the decode pool "
            "unchanged")

        g0 = scrape(pport)["tpu_serving_kv_handoff_device_downgrades_total"]
        shm = process_hop(pport, 6, "(c) shm", device=True,
                          device_domain=DISAGG_DOMAIN)
        g1 = scrape(pport)["tpu_serving_kv_handoff_device_downgrades_total"]
        if shm["path"] != "shm" or g1 != g0:
            raise RuntimeError(f"(c) hop {shm}, downgrades {g1 - g0}")
        rec["shm"] = shm
        log(f"  (c) shm: {shm}, 0 downgrades")

        # (d) the owner serves prompt 7 itself; the decode replica pulls
        http_ok(pport, "/generate", {"tokens": prompts[7],
                                     "max_new_tokens": 1})
        c0 = counters_of(dport)
        pulled = http_ok(dport, "/kv_fetch", {
            "tokens": prompts[7], "owner_url": p_url,
            "owner_domain": DISAGG_DOMAIN, "model": cfg.name})
        if not pulled["ok"] or pulled["pages"] != len(prompts[7]) // 16:
            raise RuntimeError(f"(d) pull answered {pulled}")
        got = http_ok(dport, "/generate", {
            "tokens": prompts[7], "max_new_tokens": DISAGG_NEW})["tokens"]
        decode_hop_checks(c0, counters_of(dport), prompts[7], got, refs[7],
                          "(d) pull")
        # the owner serves another run, then newer runs evict it: its
        # pool holds 256 pages, the fillers 6 x 56 (a probe in between
        # would match the run and make it the newest)
        http_ok(pport, "/generate", {"tokens": cold_prompt,
                                     "max_new_tokens": 1})
        fillers = 6
        for _ in range(fillers):
            http_ok(pport, "/generate", {"tokens": gen(900),
                                         "max_new_tokens": 1})
        status, _ = http_post(pport, "/kv_pull", {"tokens": cold_prompt})
        if status != 404:
            raise RuntimeError(f"(d) the owner's /kv_pull of the evicted "
                               f"run answered {status}")
        gone = http_ok(dport, "/kv_fetch", {
            "tokens": cold_prompt, "owner_url": p_url,
            "owner_domain": DISAGG_DOMAIN, "model": cfg.name})
        c0 = counters_of(dport)
        got = http_ok(dport, "/generate", {
            "tokens": cold_prompt, "max_new_tokens": DISAGG_NEW})["tokens"]
        c1 = counters_of(dport)
        if gone != {"ok": False, "gone": True, "error": gone.get("error")} \
                or got != refs["cold"] \
                or c1["prefix_cache_misses"] - c0["prefix_cache_misses"] != 1:
            raise RuntimeError(f"(d) evicted run: fetch {gone}, tokens "
                               f"{got} vs {refs['cold']}")
        rec["pull"] = {"path": pulled["path"], "pages": pulled["pages"],
                       "fillers_to_evict": fillers, "gone": True}
        log(f"  (d) pull over {pulled['path']}: {pulled['pages']} pages, the "
            f"tail alone prefilled; after {fillers} fillers the owner "
            "answered 404 gone and the request prefilled whole")
        stop_replicas(procs)
        procs = []

        log("  (e) --kv-int8 through the wire rung (engines of this process)")
        rec["kv_int8"] = layout_wire_run(
            torch, [disagg_engine(torch, dev, cfg, params, kv_int8=True)
                    for _ in range(3)], prompts[4],
            (paged_attention_multi_quant, rms_norm), "(e) --kv-int8")

        log(f"  (f) [{card}] times of each rung and TTFT")
        timed = [gen(DISAGG_TIMED_TOKENS) for _ in range(5)]
        rec["times"] = rung_times(torch, pre, dec, timed[:3], card)
        t0 = time.perf_counter()
        http_ok(ports[0], "/kv_prefill", {
            "request": {"tokens": timed[3]}, "handoff_to": dec_url,
            "device": True})
        http_ok(ports[2], "/generate", {"tokens": timed[3],
                                        "max_new_tokens": 1})
        two_hop = time.perf_counter() - t0
        t0 = time.perf_counter()
        http_ok(ports[2], "/generate", {"tokens": timed[4],
                                        "max_new_tokens": 1})
        unified = time.perf_counter() - t0
        rec["ttft_s"] = {"two_hop_device": two_hop, "unified": unified,
                         "tokens": DISAGG_TIMED_TOKENS}
        log(f"  (f) [{card}] TTFT of a {DISAGG_TIMED_TOKENS}-token prompt: "
            f"two hops over the device rung {two_hop * 1e3:.1f} ms, one "
            f"unified replica {unified * 1e3:.1f} ms (no claim)")
    finally:
        stop_replicas(procs)
        BUS.unregister(dec_url)
        for f in fronts:
            f.shutdown()
            f.server_close()
        for e in (pre, pre_s, dec):
            e.stop()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def http_post_bytes(port: int, path: str, body: bytes) -> tuple[int, bytes]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def stop_replicas(procs) -> None:
    for proc, _, _ in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc, _, _ in procs:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def layout_wire_run(torch, engines, prompt, kernels, what: str) -> dict:
    """A prefill, a decode and a unified engine of one layout (started,
    stopped here): the unified tokens first, then a wire hop between the
    first two behind ``serve_main.serve`` fronts; the decode engine's
    tokens equal the unified engine's after prefilling the tail alone,
    ``section_spec`` is the same on both sides, and the handoff path
    launched each of ``kernels`` (counts at 0 just before)."""
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main
    pre, dec, uni = engines
    fronts = []
    try:
        want = unified_tokens(uni, prompt)
        uni.stop()
        spec = pre._kv_store.section_spec()
        if spec != dec._kv_store.section_spec():
            raise RuntimeError(f"{what}: section specs differ")
        fronts = [serve_main.serve(e, 0, host="127.0.0.1")
                  for e in (pre, dec)]
        for k in kernels:
            k.launches = 0
        out = http_ok(fronts[0].server_address[1], "/kv_prefill", {
            "request": {"tokens": prompt},
            "handoff_to": f"http://127.0.0.1:{fronts[1].server_address[1]}"})
        if out["path"] != "wire":
            raise RuntimeError(f"{what}: hop {out}")
        pages = same_pages(torch, dec, pre, prompt, what)
        c0 = dict(dec.counters)
        got = greedy(dec, prompt)
        decode_hop_checks(c0, dict(dec.counters), prompt, got, want, what)
        launches = {k.__name__: k.launches for k in kernels}
        if pre.device.type == "cuda" and not all(launches.values()):
            raise RuntimeError(f"{what}: the handoff path launched "
                               f"{launches}")
        log(f"  {what}: {pages} pages, {out['bytes']} B over the wire, "
            f"spec {sorted(spec)}, tokens equal to the unified engine's; "
            f"launches {launches}")
        return {"pages": pages, "bytes": out["bytes"], "launches": launches,
                "sections": sorted(spec)}
    finally:
        for f in fronts:
            f.shutdown()
            f.server_close()
        for e in engines:
            e.stop()
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 9g: Gemma 2 and 3 training ---------------------------------------------

def gemma_kernel_cases(torch, F, dev) -> dict:
    """Phase 9g (a): rows 1-3 at the Gemma shapes of a train step and row
    16 at a ``seq`` = 2 shard (``GEMMA_FLASH_CASES`` through
    ``flash_case``: the controls of ``flash_controls`` and the capped cases
    again at q LARGE_Q times larger), row 12 forward and backward at
    Gemma's widths and Gemma 3's q/k norm rows (``GEMMA_RMS_SHAPES``, the
    control a dx without the mean square's term), each against its plain
    version with times, bounds and the library's (SDPA, or compiled
    ``flex_attention`` under the cap)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    try:
        flash = [flash_case(torch, F, dev, flush, *case)
                 for case in GEMMA_FLASH_CASES]
        gc.collect()
        torch.cuda.empty_cache()
        rms = [rms_case(torch, F, dev, flush, shape, grad=True, control=True)
               for shape in GEMMA_RMS_SHAPES]
    finally:
        del flush
        gc.collect()
        torch.cuda.empty_cache()
    return {"flash": flash, "rms_norm": rms}


def gemma_plain_nll(torch, cfg, params, batch, block: int = 1024,
                    chunk: int = 2048):
    """Mean next-token NLL of ``batch`` (B, S + 1) from a plain f32
    forward of every branch of a Gemma 2 or 3 config over the whole rows
    (``interleave_logits``'s branches: the embedding multiplier, the
    zero-centered norms, the q/k norm, each layer's window and RoPE table,
    the score soft cap, the sandwich norms, GeGLU, the tied head and its
    final soft cap), no kernels, differentiable in the f32 params; each
    layer (``interleave_layer``) and each ``chunk`` rows of the head's
    logits under ``torch.utils.checkpoint``."""
    import torch.utils.checkpoint

    from k8s_runpod_kubelet_tpu_torch.ops.rmsnorm import _rms_norm_plain
    from k8s_runpod_kubelet_tpu_torch.ops.rope import rope_frequencies

    dev = params["tok_embed"].device
    hd = cfg.head_dim_
    glob = rope_frequencies(hd, cfg.max_seq_len, cfg.rope_theta,
                            cfg.rope_scaling, device=dev)
    loc = (glob if cfg.rope_local_theta is None else
           rope_frequencies(hd, cfg.max_seq_len, cfg.rope_local_theta, None,
                            device=dev))
    windows = cfg.layer_windows()

    def norm(x, w):
        return _rms_norm_plain(x, w + 1 if cfg.norm_zero_centered else w,
                               cfg.norm_eps)

    tokens, targets = batch[:, :-1], batch[:, 1:].long()
    x = params["tok_embed"][tokens.long()].float()
    if cfg.embed_scale:
        x = x * cfg.embed_multiplier
    for i in range(cfg.n_layers):
        window = windows[i % len(windows)]
        lp = {k: layer_f32(w, i) for k, w in params["layers"].items()}
        x = torch.utils.checkpoint.checkpoint(
            interleave_layer, torch, cfg, lp, x, window,
            loc if window is not None else glob, cfg.attn_logit_softcap,
            cfg.post_norms, norm, lambda t: t, block, use_reentrant=False)
    x = norm(x, params["final_norm"].float())
    head = (params["tok_embed"] if cfg.tie_embeddings
            else params["lm_head"].t())

    def nll(xc, tc):
        logits = xc @ head.float().t()
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, tc[..., None])[..., 0]).sum()

    s = tokens.shape[1]
    total = sum(torch.utils.checkpoint.checkpoint(
        nll, x[:, i:i + chunk], targets[:, i:i + chunk], use_reentrant=False)
        for i in range(0, s, chunk))
    return total / (tokens.shape[0] * s)


def gemma_grad_check(torch, dev, cfg, params, batch, chunks: int) -> dict:
    """Step 1's gradients as the Gemma train step computes them
    (``loss_and_grads`` with the fused loss over ``chunks`` vocab chunks:
    bf16 through the kernels, remat) against autograd of
    ``gemma_plain_nll`` on the same f32 master params and batch: each
    leaf's relative L2 error and the global norm's relative error within
    phase 9's limits; the same path with the dK/dV kernel's output zeroed
    (the control) must exceed the leaf limit."""
    from k8s_runpod_kubelet_tpu_torch.models import LlamaModel
    from k8s_runpod_kubelet_tpu_torch.ops import attention
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        _leaves, global_norm, loss_and_grads)

    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nll = gemma_plain_nll(torch, cfg, params, batch)
    ref = torch.autograd.grad(nll, leaves)
    ref_loss = nll.item()
    del nll
    ref_norm = global_norm(ref).item()
    ref_s = time.perf_counter() - t0
    model = LlamaModel(cfg, dev)

    def against_ref() -> dict:
        loss, grads = loss_and_grads(model, params, batch,
                                     fused_ce_chunks=chunks)
        errs = {n: ((g.float() - r).norm() / r.norm()).item()
                for n, g, r in zip(names, grads, ref)}
        norm = global_norm(grads).item()
        del grads
        worst = max(errs, key=errs.get)
        return {"loss": loss.item(), "grad_norm": norm,
                "norm_rel_err": abs(norm - ref_norm) / ref_norm,
                "leaf_rel_l2": errs, "worst_leaf": worst,
                "worst_leaf_rel_l2": errs[worst]}

    try:
        port = against_ref()
        real_dkv = attention.flash_dkv
        attention.flash_dkv = lambda q, k, v, *a, **kw: (torch.zeros_like(k),
                                                         torch.zeros_like(v))
        try:
            control = against_ref()
        finally:
            attention.flash_dkv = real_dkv
    finally:
        for p in leaves:
            p.requires_grad_(False)
    peak = torch.cuda.max_memory_allocated()
    del ref, model, leaves
    gc.collect()
    torch.cuda.empty_cache()
    out = {"ref_loss": ref_loss, "ref_grad_norm": ref_norm, "ref_s": ref_s,
           "peak_bytes": peak, "port": port, "control_zero_dkv": control,
           "limit_leaf_rel_l2": TRAIN_GRAD_REL_L2_LIMIT,
           "limit_norm_rel": TRAIN_NORM_REL_LIMIT}
    log(f"  gradients vs autograd of the plain f32 Gemma forward (batch "
        f"{batch.shape[0]} x {batch.shape[1] - 1}, {ref_s:.1f} s, peak "
        f"{peak / 2**30:.2f} GiB): loss {port['loss']:.5f} vs "
        f"{ref_loss:.5f}; grad_norm {port['grad_norm']:.5f} vs "
        f"{ref_norm:.5f} (rel {port['norm_rel_err']:.2e}, limit "
        f"{TRAIN_NORM_REL_LIMIT}); worst leaf {port['worst_leaf']} rel L2 "
        f"{port['worst_leaf_rel_l2']:.2e} (limit {TRAIN_GRAD_REL_L2_LIMIT})")
    log("    leaf rel L2: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (dK/dV zeroed): worst leaf {control['worst_leaf']} rel "
        f"L2 {control['worst_leaf_rel_l2']:.3f}, grad_norm rel "
        f"{control['norm_rel_err']:.2e}")
    if not (port["worst_leaf_rel_l2"] <= TRAIN_GRAD_REL_L2_LIMIT
            and port["norm_rel_err"] <= TRAIN_NORM_REL_LIMIT):
        raise RuntimeError(f"Gemma training gradients off the plain "
                           f"forward's: {port}")
    if not control["worst_leaf_rel_l2"] > TRAIN_GRAD_REL_L2_LIMIT:
        raise RuntimeError(f"the zeroed-dK/dV control passed: {control}")
    return out


def step_device_ms(torch, trainer, batch) -> dict:
    """``step_profile``'s profile of one more train step (after its
    warm-up steps): the wall and the kernels' device time by family, rows
    1-3 apart with their share and dK/dV's of the step's device time."""
    from k8s_runpod_kubelet_tpu_torch.workloads.step_profile import _profile

    batches = itertools.repeat(batch)
    prof = _profile(lambda: trainer.run(steps=1, batches=batches), 1)
    fam = prof["device_ms_by_family"]
    if not isinstance(fam, dict):
        return prof
    rows = {k: fam.get(k, 0.0) for k in ("flash_fwd", "flash_dq",
                                           "flash_dkv")}
    return dict(prof, flash_ms=rows,
                flash_share=sum(rows.values()) / prof["device_ms"],
                flash_dkv_share=rows["flash_dkv"] / prof["device_ms"])


def gemma_train_run(torch, dev, card: str, name: str, layers: int) -> dict:
    """Phase 9g (b): ``name`` at full width and ``layers`` layers, its
    norms drawn away from identity (``draw_family_branches``), batch 1 x
    GEMMA_TRAIN_SEQ with the fused loss over FT_CHUNKS chunks: the
    gradient check, then GEMMA_TRAIN_STEPS steps on the repeated seeded
    batch with exact launches a step (flash_fwd 2L, flash_dq L, flash_dkv
    L, rms_norm (2 + 2 sandwich + 2 q/k) x 2L + 1), the loss falling, step
    1's grad_norm within phase 9's limit of the plain forward's, then one
    profiled step (``step_device_ms``)."""
    from k8s_runpod_kubelet_tpu_torch.models import MODEL_CONFIGS, init_params
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, Trainer, _leaves, synthetic_batches)

    cfg = dataclasses.replace(MODEL_CONFIGS[name](), n_layers=layers)
    tc = TrainConfig(batch_size=1, seq_len=GEMMA_TRAIN_SEQ,
                     steps=GEMMA_TRAIN_STEPS, warmup_steps=1,
                     fused_ce_chunks=FT_CHUNKS)
    batch = next(synthetic_batches(cfg, tc, seed=SEED, device=dev))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    draw_family_branches(torch, cfg, params, SEED + 400)
    check = gemma_grad_check(torch, dev, cfg, params, batch, FT_CHUNKS)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tc, device=dev, initial_params=params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(trainer.params))
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    norms = 2 + 2 * cfg.post_norms + 2 * cfg.qk_norm
    per_step = {"flash_fwd": 2 * layers, "flash_dq": layers,
                "flash_dkv": layers, "rms_norm": 2 * norms * layers + 1}
    log(f"  {name} widths, {layers} layers (windows "
        f"{cfg.layer_windows()}): {n_params / 1e9:.3f} B params (f32 "
        f"master), trainer init {init_s:.1f} s; batch 1 x "
        f"{GEMMA_TRAIN_SEQ}, remat {cfg.remat_policy}, fused_ce_chunks "
        f"{FT_CHUNKS}")
    # the main path: counts set to 0 just before the run, read just after
    for k in kernels:
        k.launches = 0
    run = timed_steps(torch, trainer, itertools.repeat(batch), tc.steps,
                      kernels, per_step)
    launches = {k.__name__: k.launches for k in kernels}
    losses, norms_ = run["losses"], run["grad_norms"]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: the loss did not fall: {losses}")
    step1_rel = abs(norms_[0] - check["ref_grad_norm"]) / check[
        "ref_grad_norm"]
    if not step1_rel <= TRAIN_NORM_REL_LIMIT:
        raise RuntimeError(f"{name}: step 1's grad_norm {norms_[0]} is off "
                           f"the plain forward's {check['ref_grad_norm']}")
    prof = step_device_ms(torch, trainer, batch)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [{card}] {name} at {layers} layers: step wall "
        f"{run['step_s_median']:.4f} s (median of steps 2-{tc.steps}; "
        f"first {run['step_walls_s'][0]:.3f} s), {run['tokens_per_s']:.0f} "
        f"tokens/s, peak {run['peak_bytes'] / 2**30:.2f} GiB allocated; "
        f"step 1 grad_norm rel {step1_rel:.2e} of the plain forward's; "
        f"launches over {tc.steps} steps {launches} ({per_step} a step)")
    if "flash_ms" in prof:
        log(f"  [{card}] {name} profiled step: wall {prof['wall_ms']:.2f} "
            f"ms, device {prof['device_ms']:.2f} ms (busy "
            f"{prof['device_busy_share']:.1%}); rows 1-3 "
            + " / ".join(f"{v:.2f}" for v in prof["flash_ms"].values())
            + f" ms (fwd / dQ / dK/dV), {prof['flash_share']:.1%} of the "
            f"device time, dK/dV {prof['flash_dkv_share']:.1%}; by family "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                prof["device_ms_by_family"].items(), key=lambda kv: -kv[1])))
    else:
        log(f"  {name} profiled step: the trace shows no device time")
    return {"model": name, "layers": layers, "params": n_params,
            "batch": 1, "seq_len": GEMMA_TRAIN_SEQ, "init_s": init_s,
            "grad_check": check, "step1_norm_rel_err": step1_rel,
            "launches": launches, "launches_per_step": per_step,
            "profile": prof, **run}


def gemma_ring_check(torch, dev, card: str) -> dict:
    """Phase 9g (e): gemma2-9b widths at 4 layers on an in-process ``seq``
    = 2 mesh with ``ring_flash`` (row 16 at D = 256: the local layers'
    band over the ring, their steps cut by ``_ring_steps``, the global
    ones the whole context, both capped at 50), the step's gradients
    (``loss_and_grads``, the fused loss) and final hidden states against
    the unsharded step's on the same params and batch (the ``RING_*``
    limits), launches exact (the path counted); the control, every ring
    offset forced to 0, must exceed them."""
    from k8s_runpod_kubelet_tpu_torch.models import (LlamaModel, gemma2_9b,
                                                     init_params)
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.ops.ring_attention import _ring_steps
    from k8s_runpod_kubelet_tpu_torch.parallel import MeshConfig, make_mesh
    from k8s_runpod_kubelet_tpu_torch.workloads.train import (
        TrainConfig, _leaves, loss_and_grads, synthetic_batches)

    shards, layers = 2, GEMMA_TRAIN_DEPTH["gemma2-9b"]
    cfg = dataclasses.replace(gemma2_9b(), n_layers=layers)
    tc = TrainConfig(batch_size=1, seq_len=GEMMA_TRAIN_SEQ)
    batch = next(synthetic_batches(cfg, tc, seed=SEED + 1, device=dev))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev, master=True)
    draw_family_branches(torch, cfg, params, SEED + 400)
    leaves = [p.requires_grad_() for p in _leaves(params)]
    names = leaf_names(params)
    mesh = make_mesh(MeshConfig(seq=shards))
    flat = LlamaModel(cfg, dev)
    ring = LlamaModel(dataclasses.replace(cfg, ring_flash=True), dev, mesh)
    inputs = batch[:, :-1]
    s_local = GEMMA_TRAIN_SEQ // shards
    steps = [_ring_steps(shards, s_local, w) for w in
             (cfg.layer_windows()[i % len(cfg.layer_windows())]
              for i in range(layers))]
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_call = {"flash_fwd": 2 * sum(steps), "flash_dq": sum(steps),
                "flash_dkv": sum(steps),
                "rms_norm": 2 * 4 * layers + 1}
    try:
        t0 = time.perf_counter()
        loss_f, grads_f = loss_and_grads(flat, params, batch,
                                         fused_ce_chunks=FT_CHUNKS)
        torch.cuda.synchronize()
        flat_s = time.perf_counter() - t0

        def against_flat(model, count: bool) -> dict:
            with torch.no_grad():
                rel_h = rel_l2(torch, model.forward(params, inputs,
                                                    return_hidden=True),
                               flat.forward(params, inputs,
                                            return_hidden=True))
            if count:
                for k in kernels:
                    k.launches = 0
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, params, batch,
                                         fused_ce_chunks=FT_CHUNKS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k.__name__: k.launches for k in kernels} if count else None
            errs = {n: ((g.float() - f.float()).norm()
                        / f.float().norm()).item()
                    for n, g, f in zip(names, grads, grads_f)}
            del grads
            worst = max(errs, key=errs.get)
            return {"loss": loss.item(), "hidden_rel_l2": rel_h,
                    "leaf_rel_l2": errs, "worst_leaf": worst,
                    "worst_leaf_rel_l2": errs[worst], "wall_s": wall,
                    "launches": got}

        port = against_flat(ring, True)
        ring_mod = importlib.import_module(
            "k8s_runpod_kubelet_tpu_torch.ops.ring_attention")
        real = {n: getattr(ring_mod, n) for n in
                ("flash_fwd", "flash_dq", "flash_dkv")}
        for n, fn in real.items():
            setattr(ring_mod, n, lambda *a, _fn=fn, **kw: _fn(
                *a, **dict(kw, q_offset=0)))
        try:
            control = against_flat(ring, False)
        finally:
            for n, fn in real.items():
                setattr(ring_mod, n, fn)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    loss_rel = abs(port["loss"] - loss_f.item()) / loss_f.item()
    del params, leaves, grads_f, flat, ring
    gc.collect()
    torch.cuda.empty_cache()
    out = {"layers": layers, "shards": shards, "seq_len": GEMMA_TRAIN_SEQ,
           "ring_steps_by_layer": steps, "flat_loss": loss_f.item(),
           "flat_wall_s": flat_s, "ring_vs_flat": port,
           "loss_rel": loss_rel, "control_q_offset_0": control,
           "launches": port["launches"], "launches_expected": per_call,
           "limits": {"hidden_rel_l2": RING_LOGITS_REL_L2_LIMIT,
                      "leaf_rel_l2": RING_GRAD_REL_L2_LIMIT}}
    log(f"  (e) [{card}] gemma2-9b widths, {layers} layers, seq 2 x "
        f"{s_local} (ring steps by layer {steps}): the ring's step vs the "
        f"unsharded step: loss {port['loss']:.5f} vs {loss_f.item():.5f} "
        f"(rel {loss_rel:.2e}), hidden rel L2 {port['hidden_rel_l2']:.2e} "
        f"(limit {RING_LOGITS_REL_L2_LIMIT}), worst leaf "
        f"{port['worst_leaf']} {port['worst_leaf_rel_l2']:.2e} (limit "
        f"{RING_GRAD_REL_L2_LIMIT}); gradients {port['wall_s']:.3f} s "
        f"against {flat_s:.3f} s unsharded (first calls); launches "
        f"{port['launches']} ({per_call} expected)")
    log("    leaf rel L2 vs unsharded: " + ", ".join(
        f"{n} {e:.2e}" for n, e in port["leaf_rel_l2"].items()))
    log(f"    control (ring offsets forced to 0): hidden rel L2 "
        f"{control['hidden_rel_l2']:.3f}, worst leaf "
        f"{control['worst_leaf']} {control['worst_leaf_rel_l2']:.3f}")
    if port["launches"] != per_call:
        raise RuntimeError(f"(e) the ring step launched {port['launches']}"
                           f", not {per_call}")
    if not (port["hidden_rel_l2"] <= RING_LOGITS_REL_L2_LIMIT
            and port["worst_leaf_rel_l2"] <= RING_GRAD_REL_L2_LIMIT):
        raise RuntimeError(f"(e) the ring is off the unsharded step: {port}")
    if not (control["hidden_rel_l2"] > RING_LOGITS_REL_L2_LIMIT
            and control["worst_leaf_rel_l2"] > RING_GRAD_REL_L2_LIMIT):
        raise RuntimeError(f"(e) the zero-offset control passed: {control}")
    return out


def gemma_near_ties(torch, cfg, params, prompt, got, want) -> list:
    """Where two greedy runs of ``prompt`` part (``got`` against
    ``want``): the position and the top-2 margin of the plain f32
    forward's (``interleave_logits``) last logits there, as a share of
    their RMS; raises unless it is under SPEC_TIE_MARGIN. Runs that part
    are compared no further than their first difference."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        with torch.no_grad():
            ref = interleave_logits(torch, cfg, params, prompt + want[:i])
        top2 = ref.topk(2).values
        share = ((top2[0] - top2[1]) / ref.pow(2).mean().sqrt()).item()
        out.append({"at": i, "margin_share": share})
        if not share < SPEC_TIE_MARGIN:
            raise RuntimeError(f"(d) token {i}: {a} against {b}, top-2 "
                               f"margin {share:.3f} of the RMS")
        break
    return out


def gemma_prefix_variants(torch, base: dict, argv: list, adapter_path: str,
                          prompt: list, rng, n: int) -> dict:
    """Phase 9g (d)'s registered prefix on the contiguous loop's dense
    store: ``serve_main`` with ``argv`` (``--prefix-cache off``, so
    prefixes live whole in ``DensePrefixStore`` and ``_prefill_dense``
    serves them) over the frozen base, 'ft' registered by ``POST
    /adapters``; the first GEMMA_SERVE_PREFIX tokens of ``prompt`` through
    ``POST /prefix``, then ``prompt`` under 'ft' twice (the first fills the
    adapter's variant, the second copies it: the same tokens), a base
    prompt over the prefix (a hit on the base variant), 'ft' registered
    again (its variant dropped, the base one kept) and ``prompt`` under
    'ft' once more (filled anew: the same tokens). Raises where the fill
    and hit counters, the variants or the tokens differ from that, or
    where a decode step was not one replay of the one capture (g5)."""
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    engine, _ = serve_main.build_engine(serve_main.parse_args(argv), base)
    httpd = serve_main.serve(engine, port=0, host="127.0.0.1",
                             allow_adapters=True)
    port = httpd.server_address[1]
    try:
        if engine._dense_prefixes is None:
            raise RuntimeError("(d) the prefix engine has no dense store")
        out = prefix_variant_checks(engine, port, prompt, adapter_path, rng,
                                    n)
        out["graphs"] = graphs_used_check(engine, "(d) the prefix engine")
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def prefix_variant_checks(engine, port: int, prompt: list, adapter_path: str,
                          rng, n: int) -> dict:
    """The steps and checks of ``gemma_prefix_variants`` on a running
    engine behind ``serve_main.serve`` at ``port``."""
    code, body = http_post(port, "/adapters", {"name": "ft",
                                               "path": adapter_path})
    if code != 200:
        raise RuntimeError(f"(d) POST /adapters answered {code}: {body}")
    prefix = prompt[:GEMMA_SERVE_PREFIX]
    code, body = http_post(port, "/prefix", {"tokens": prefix})
    if code != 200:
        raise RuntimeError(f"(d) POST /prefix answered {code}: {body}")
    store = engine._dense_prefixes
    slot = engine._adapter_names["ft"]

    def state() -> dict:
        with engine._prefix_lock:
            entry = store.lookup(prompt)
            return {"fills": engine.counters["prefix_adapter_fills"],
                    "hits": engine.counters["prefix_hits"],
                    "variants": sorted(entry.variants)}

    def run(tokens, adapter) -> list:
        return engine.submit(tokens, max_new_tokens=n, adapter=adapter
                             ).result(timeout=600)["tokens"]

    base_prompt = prefix + rng.integers(0, engine.cfg.vocab_size,
                                        40).tolist()
    states, toks = [state()], []
    for tokens, adapter in ((prompt, "ft"), (prompt, "ft"),
                            (base_prompt, "")):
        toks.append(run(tokens, adapter))
        states.append(state())
    code, body = http_post(port, "/adapters", {"name": "ft",
                                               "path": adapter_path})
    if code != 200:
        raise RuntimeError(f"(d) POST /adapters again answered {code}")
    states.append(state())
    toks.append(run(prompt, "ft"))
    states.append(state())
    f0, h0 = states[0]["fills"], states[0]["hits"]
    want = [(f0, h0, [0]), (f0 + 1, h0, [0, slot]),
            (f0 + 1, h0 + 1, [0, slot]), (f0 + 1, h0 + 2, [0, slot]),
            (f0 + 1, h0 + 2, [0]), (f0 + 2, h0 + 2, [0, slot])]
    got = [(st["fills"], st["hits"], st["variants"]) for st in states]
    if got != want:
        raise RuntimeError(f"(d) prefix fills, hits and variants {got}, "
                           f"not {want}")
    if not toks[0] == toks[1] == toks[3]:
        raise RuntimeError(f"(d) 'ft' over the prefix: {toks[0]}, copied "
                           f"{toks[1]}, after re-registration {toks[3]}")
    log(f"  (d) prefix of {len(prefix)} tokens (POST /prefix): (fills, hits, "
        f"variants) {got} after registration, 'ft' twice, a base prompt, "
        f"'ft' registered again and 'ft' once more; 'ft' tokens equal "
        "each time")
    return {"prefix_tokens": len(prefix), "states": states, "tokens": toks}


def gemma_serve_adapter(torch, dev, card: str, cfg, base: dict,
                        adapter_path: str, pattern) -> dict:
    """Phase 9g (d): (c)'s adapter served on the contiguous loop through
    ``serve_main`` (``--lora-rank 16`` over its targets,
    ``--dynamic-adapters``, 4 slots, GEMMA_SERVE_CACHE_LEN) over the frozen
    bf16 base: registered by ``POST /adapters`` after the decode graph's
    capture, then one burst mixing two adapter and two base requests (a
    decode step must hold both) and the same adapter request through
    ``/generate``; rms_norm and flash_fwd launches exact a step and a
    prefill call; (g1)-(g5) with mixed ids, 0 recaptures. Then the same
    flags with ``--prefix-cache off`` over a registered prefix
    (``gemma_prefix_variants``: the dense store's adapter variants). The
    adapter's greedy tokens, and its first tokens over the prefix,
    against the same engine's (``serve_main`` without ``--lora-rank``)
    over ``merge_lora`` of the base and the adapter: equal, or parting at
    a near tie of the plain f32 forward of the merged weights
    (``gemma_near_ties``)."""
    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models.lora import (load_adapter,
                                                          merge_lora)
    from k8s_runpod_kubelet_tpu_torch.ops import flash_fwd, rms_norm
    from k8s_runpod_kubelet_tpu_torch.workloads import serve_main

    adapter = load_adapter(adapter_path)
    n = GEMMA_SERVE_TOKENS
    common = ["--model", cfg.name, "--device", dev.type, "--slots", "4",
              "--cache-len", str(GEMMA_SERVE_CACHE_LEN), "--max-new-tokens",
              str(n)]
    rng = np.random.default_rng(SEED + 9)
    traffic = [(np.resize(pattern, 150).tolist(), "ft"),
               (rng.integers(0, cfg.vocab_size, 120).tolist(), ""),
               (np.resize(np.roll(pattern, 20), 130).tolist(), "ft"),
               (rng.integers(0, cfg.vocab_size, 90).tolist(), "")]
    engine, _ = serve_main.build_engine(serve_main.parse_args(
        common + ["--lora-rank", str(FT_RANK), "--lora-targets",
                  ",".join(adapter), "--max-adapters", "1",
                  "--dynamic-adapters"]), base)
    httpd = serve_main.serve(engine, port=0, host="127.0.0.1",
                             allow_adapters=True)
    port = httpd.server_address[1]
    what = f"{cfg.name} LoRA contiguous engine"
    kernels = (flash_fwd, rms_norm)
    try:
        snap = engine.debug_snapshot()
        if snap["paged_decode"] or not snap["multi_lora"]:
            raise RuntimeError(f"(d) {what}: paged_decode "
                               f"{snap['paged_decode']}, multi_lora "
                               f"{snap['multi_lora']}")
        code, body = http_post(port, "/adapters",
                               {"name": "ft", "path": adapter_path})
        if code != 200:
            raise RuntimeError(f"(d) POST /adapters answered {code}: {body}")
        c0 = dict(engine.counters)
        l0 = {k.__name__: k.launches for k in kernels}
        seq0 = last_seq(engine)
        futs = [engine.submit(p, max_new_tokens=n, adapter=a)
                for p, a in traffic]
        got = [f.result(timeout=600)["tokens"] for f in futs]
        code, body = http_post(port, "/generate", {
            "tokens": traffic[0][0], "adapter": "ft", "max_new_tokens": n})
        if code != 200 or json.loads(body)["tokens"] != got[0]:
            raise RuntimeError(f"(d) /generate with the adapter: {code} "
                               f"{body[:200]!r} against {got[0]}")
        wait_for(lambda: engine.active_slots == 0, "the engine idle", 60)
        c1 = engine.counters
        launches = {k.__name__: k.launches - l0[k.__name__] for k in kernels}
        steps = {k: c1[k] - c0[k] for k in ("decode_steps",
                                            "dense_prefill_heads",
                                            "dense_prefill_chunks")}
        records = [r for r in engine.recorder.records()
                   if r["seq"] > seq0 and r["batch"]["mode"] == "decode"]
        mixed = sum(1 for r in records
                    if 0 < r["batch"]["adapters"] < r["batch"]["active"])
        norms = (2 + 2 * cfg.post_norms + 2 * cfg.qk_norm) * cfg.n_layers + 1
        want_l = {"flash_fwd": cfg.n_layers * steps["dense_prefill_heads"],
                  "rms_norm": norms * sum(steps.values())}
        if launches != want_l:
            raise RuntimeError(f"(d) launches {launches}, not {want_l} for "
                               f"{steps}")
        if not mixed:
            raise RuntimeError("(d) no decode step mixed base and adapter "
                               "rows")
        with engine._prefix_lock:
            graphs = contiguous_graph_checks(torch, engine, card,
                                             ENGINE_REL_L2_LIMIT, what,
                                             ids=[0, 1, 1, 0][:4])
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    prefixed = gemma_prefix_variants(
        torch, base, common + ["--lora-rank", str(FT_RANK), "--lora-targets",
                               ",".join(adapter), "--max-adapters", "1",
                               "--dynamic-adapters", "--prefix-cache", "off"],
        adapter_path, traffic[0][0], rng, n)
    wrapped = dict(base)
    wrapped["layers"] = dict(base["layers"])
    for t, ad in adapter.items():
        wrapped["layers"][t] = {
            "w": base["layers"][t],
            **{k: torch.from_numpy(ad[src]).to(dev) for k, src in
               (("lora_a", "a"), ("lora_b", "b"), ("scale", "scale"))}}
    merged = merge_lora(wrapped)
    del wrapped
    m_engine, _ = serve_main.build_engine(serve_main.parse_args(common),
                                          merged)
    try:
        want = [m_engine.submit(p, max_new_tokens=n).result(
            timeout=600)["tokens"] for p, a in traffic if a]
    finally:
        m_engine.stop()
        del m_engine
    # the adapter's tokens over the prefix beside them: the first prompt's
    ft_got = [t for t, (_, a) in zip(got, traffic) if a]
    ft_got.append(prefixed["tokens"][0])
    want.append(want[0])
    ft_prompts = [p for p, a in traffic if a] + [traffic[0][0]]
    ties = [gemma_near_ties(torch, cfg, merged, p, g, w)
            for p, g, w in zip(ft_prompts, ft_got, want)]
    with torch.no_grad():
        last_m = interleave_logits(torch, cfg, merged, ft_prompts[0])
        last_b = interleave_logits(torch, cfg, base, ft_prompts[0])
    moved = ((last_m - last_b).norm() / last_b.norm()).item()
    del merged, last_m, last_b
    gc.collect()
    torch.cuda.empty_cache()
    equal = [g == w for g, w in zip(ft_got, want)]
    out = {"tokens": got, "merged_tokens": want, "equal": equal,
           "near_ties": ties, "launches": launches, "steps": steps,
           "mixed_decode_steps": mixed, "decode_records": len(records),
           "prefix": prefixed,
           "graphs": graphs, "adapter_moves_last_logits_rel_l2": moved,
           "tie_margin": SPEC_TIE_MARGIN}
    log(f"  (d) [{card}] {what}: adapter 'ft' registered by POST /adapters "
        f"after the capture; {len(traffic)} requests (2 'ft', 2 base) of "
        f"{n} greedy tokens: {got}; the merged weights' engine {want[:-1]}; "
        f"the first 'ft' prompt over the registered prefix {ft_got[-1]}: "
        f"equal {equal} (near ties {ties}); {mixed} of {len(records)} decode "
        f"steps mixed base and adapter rows; launches {launches} over "
        f"{steps}; the adapter moves the f32 last-token logits by "
        f"{moved:.4f} relative L2")
    return out


def gemma_finetune(torch, dev, card: str) -> dict:
    """Phase 9g (c) and (d): ``train_main.main --model gemma2-9b`` (all 42
    layers, random init from its seed, the frozen base drawn into bf16)
    ``--lora-rank 16`` on all seven targets ``--fused-ce-chunks 8 --batch
    1 --seq-len 4096`` for GEMMA_FT_STEPS steps from a token file (phase
    9f's seeded pattern) ``--export-adapter``: the summary line, the loss
    falling, every frozen leaf (the tied table among them) bit-identical
    after the run, launches exact a step (84 / 42 / 42 / 337), the peak
    (and the init's) within 80 GB, median step wall and tokens/s; then the
    exported adapter served (``gemma_serve_adapter``)."""
    import contextlib
    import io

    import numpy as np

    from k8s_runpod_kubelet_tpu_torch.models import gemma2_9b
    from k8s_runpod_kubelet_tpu_torch.ops import (flash_dkv, flash_dq,
                                                  flash_fwd, rms_norm)
    from k8s_runpod_kubelet_tpu_torch.workloads import train as train_mod
    from k8s_runpod_kubelet_tpu_torch.workloads import train_main

    cfg = gemma2_9b()
    n = cfg.n_layers
    kernels = (flash_fwd, flash_dq, flash_dkv, rms_norm)
    per_step = {"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n,
                "rms_norm": 2 * 4 * n + 1}
    made: list = []
    Watched = watched_trainer(torch, train_mod.Trainer, kernels, made)
    train_mod.Trainer, real_trainer = Watched, train_mod.Trainer
    out: dict = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.default_rng(SEED)
            pattern = rng.integers(0, cfg.vocab_size, FT_PATTERN)
            data = os.path.join(tmp, "tokens.bin")
            np.resize(pattern, FT_WINDOWS * GEMMA_FT_SEQ + 1).astype("<i4") \
                .tofile(data)
            adapter_path = os.path.join(tmp, "gemma_adapter.npz")
            argv = ["--model", cfg.name, "--device", dev.type,
                    "--lora-rank", str(FT_RANK),
                    "--lora-targets", ",".join(LORA_TARGETS_ALL),
                    "--fused-ce-chunks", str(FT_CHUNKS), "--batch", "1",
                    "--seq-len", str(GEMMA_FT_SEQ), "--lr", str(FT_LR),
                    "--data", data, "--steps", str(GEMMA_FT_STEPS),
                    "--export-adapter", adapter_path]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # the main path: counts set to 0 just before the run
            for k in kernels:
                k.launches = 0
            stdout = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                rc = train_main.main(argv)
            main_s = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in kernels}
            peak = torch.cuda.max_memory_allocated()
            if rc != 0 or len(made) != 1:
                raise RuntimeError(f"(c) train_main exited {rc}, "
                                   f"{len(made)} trainers")
            summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
            tr = made[0]
            if not tr.losses[-1] < tr.losses[0]:
                raise RuntimeError(f"(c) the loss did not fall: {tr.losses}")
            after = leaf_checksums(torch, tr.params, True)
            if after != tr.init_sums or "tok_embed" not in after:
                bad = [k for k in after if after[k] != tr.init_sums.get(k)]
                raise RuntimeError(f"(c) frozen leaves changed: {bad}")
            for i, got in enumerate(tr.launches):
                if got != per_step:
                    raise RuntimeError(f"(c) step {i + 1} launched {got}, "
                                       f"not {per_step}")
            if launches != {k: v * GEMMA_FT_STEPS
                            for k, v in per_step.items()}:
                raise RuntimeError(f"(c) launches over the run {launches}")
            if not max(peak, tr.init_peak) <= CARD_BYTES:
                raise RuntimeError(f"(c) peak {peak} bytes (init "
                                   f"{tr.init_peak}) does not fit the card")
            step_s = statistics.median(tr.walls[1:])
            out["finetune"] = {
                "losses": tr.losses, "step_walls_s": tr.walls,
                "step_s_median": step_s,
                "tokens_per_s": GEMMA_FT_SEQ / step_s, "peak_bytes": peak,
                "init_peak_bytes": tr.init_peak, "frozen_leaves": len(after),
                "launches": launches, "launches_per_step": per_step,
                "summary": summary, "main_s": main_s}
            log(f"  (c) [{card}] gemma2-9b ({n} layers) LoRA r={FT_RANK} on "
                f"all seven targets through train_main, batch 1 x "
                f"{GEMMA_FT_SEQ}: losses {[round(x, 4) for x in tr.losses]};"
                f" step walls {[round(w, 4) for w in tr.walls]} s, median of "
                f"steps 2-{GEMMA_FT_STEPS} {step_s:.4f} s, "
                f"{GEMMA_FT_SEQ / step_s:.0f} tokens/s; {len(after)} frozen "
                f"leaves bit-identical after the run; peak "
                f"{peak / 2**30:.2f} GiB over the steps and export "
                f"({tr.init_peak / 2**30:.2f} GiB in the init); launches a "
                f"step {per_step}; train_main {main_s:.1f} s")
            base = {k: v.detach() for k, v in tr.params.items()
                    if k != "layers"}
            base["layers"] = {k: (v["w"] if isinstance(v, dict) else v)
                              .detach()
                              for k, v in tr.params["layers"].items()}
            del tr
            made.clear()
            gc.collect()
            torch.cuda.empty_cache()
            out["serve"] = gemma_serve_adapter(torch, dev, card, cfg, base,
                                               adapter_path, pattern)
            del base
    finally:
        train_mod.Trainer = real_trainer
        made.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def gemma_train_phase(torch, F, dev, card: str) -> dict:
    """Phase 9g: (a) the kernels at the Gemma shapes, (b) gemma2-9b and
    gemma3-12b at full width and reduced depth (GEMMA_TRAIN_DEPTH), (e)
    the ``seq`` = 2 Gemma 2 step against the unsharded one, (c) the
    42-layer gemma2-9b LoRA fine-tune through ``train_main`` and (d) its
    adapter served on the contiguous loop."""
    t0 = time.perf_counter()
    out = {}
    log("  9g (a): rows 1-3 at B1 S8192 D256 16/8 (cap 50 + window 4096, "
        "cap 50, window 1024), row 16 at a 4096-token shard, row 12 at "
        "Gemma's widths with gradients")
    out["kernels"] = gemma_kernel_cases(torch, F, dev)
    for name, layers in GEMMA_TRAIN_DEPTH.items():
        log(f"  9g (b): {name} widths at {layers} layers, batch 1 x "
            f"{GEMMA_TRAIN_SEQ}, fused loss over {FT_CHUNKS} chunks")
        out[name.replace("-", "_")] = gemma_train_run(torch, dev, card, name,
                                                      layers)
    log("  9g (e): gemma2-9b widths at 4 layers on an in-process seq = 2 "
        "mesh (ring_flash) against the unsharded step")
    out["seq2"] = gemma_ring_check(torch, dev, card)
    log(f"  9g (c): gemma2-9b LoRA r={FT_RANK} on all seven targets at "
        f"full depth through train_main (batch 1 x {GEMMA_FT_SEQ}, "
        f"{GEMMA_FT_STEPS} steps), then (d) its adapter on the contiguous "
        "loop")
    out.update(gemma_finetune(torch, dev, card))
    out["phase_s"] = time.perf_counter() - t0
    log(f"  9g: {out['phase_s']:.1f} s")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chip smoke of the PyTorch "
                                "port (see the module docstring)")
    p.add_argument("--out", default="",
                   help="also write every number to this JSON file")
    p.add_argument("--qk-witness", action="store_true",
                   help="run only the gemma3-12b q/k scale witness "
                   "(qk_witness_phase), print its JSON and exit")
    p.add_argument("--moe-train", action="store_true",
                   help="run only phase 9e (MoE training; the kernels it "
                   "runs build at their first launch), print its JSON and "
                   "exit")
    p.add_argument("--gemma-train", action="store_true",
                   help="run only phase 9g (Gemma 2 and 3 training, the "
                   "LoRA fine-tune and its adapter served; the kernels it "
                   "runs build at their first launch), print its JSON and "
                   "exit")
    p.add_argument("--flex-warm", action="store_true",
                   help="compile flex_attention at the capped flash cases' "
                   "shapes into TORCHINDUCTOR_CACHE_DIR and exit (the full "
                   "run starts this in a second process)")
    p.add_argument("--disagg", action="store_true",
                   help="run only phase 7k (disaggregated serving of "
                   "llama3-8b bf16; the kernels build at their first "
                   "launch), print its JSON and exit")
    p.add_argument("--finetune", action="store_true",
                   help="run only phase 9f (c)-(f) (the LoRA fine-tune of "
                   "llama3-8b through train_main with --profile-dir, its "
                   "resume and its adapter served), print its JSON and "
                   "exit")
    p.add_argument("--contiguous-spec-tp", action="store_true",
                   help="run only phase 7g (e) and (f) (gemma2-9b bf16 on "
                   "the contiguous loop with --speculate 4, then at "
                   "--tensor-parallel 2), print its JSON and exit")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from k8s_runpod_kubelet_tpu_torch.ops import _cuda, rms_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.flex_warm:
        flex_warm(torch, dev)
        return 0
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if args.qk_witness:
        print(json.dumps(qk_witness_phase(torch, dev, card)), flush=True)
        return 0
    if args.moe_train:
        print(json.dumps(moe_train_phase(torch, dev, card)), flush=True)
        return 0
    if args.gemma_train:
        print(json.dumps(gemma_train_phase(torch, F, dev, card)), flush=True)
        return 0
    if args.finetune:
        print(json.dumps(finetune_phase(torch, dev, card), default=str),
              flush=True)
        return 0
    if args.contiguous_spec_tp:
        params = draw_interleave_tree(torch, dev, "gemma2-9b", 0)
        print(json.dumps(contiguous_spec_tp_phase(torch, dev, card, params)),
              flush=True)
        return 0
    if args.disagg:
        from k8s_runpod_kubelet_tpu_torch.models import init_params, llama3_8b
        cfg = llama3_8b()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        print(json.dumps(disagg_phase(torch, dev, card, cfg, params)),
              flush=True)
        return 0

    log("phase build")
    start_flex_warm()
    sources = ("paged_attention_multi", "paged_attention_multi_quant",
               "paged_attention_multi_mla", "paged_attention_multi_mla_quant",
               "int4_matmul", "int4_expert_matmul", "flash_attention")
    nvcc_s, errors = {}, []

    def build(name):
        t = time.perf_counter()
        try:
            _cuda.load(name)
        except Exception as e:   # re-raised below, after the join
            errors.append(e)
        nvcc_s[name] = time.perf_counter() - t

    threads = [threading.Thread(target=build, args=(n,)) for n in sources]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    rms_norm(torch.ones((1, 64), dtype=torch.bfloat16, device=dev),
             torch.ones(64, device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, text in sorted(_cuda.build_logs.items()):
        for line in ptxas_summary(text):
            log(f"  ptxas {name}: {line}")
    # the tensor-core kernels: each must hold wgmma (HGMMA in the SASS)
    with concurrent.futures.ThreadPoolExecutor(len(TENSOR_CORE_KERNELS)) \
            as pool:
        sass = dict(zip(TENSOR_CORE_KERNELS, pool.map(
            lambda name: sass_counts(_cuda.load(name)._name),
            TENSOR_CORE_KERNELS)))
    for name, counts in sass.items():
        if not counts:
            log(f"  sass {name}: no cuobjdump in the toolkit, not counted")
            continue
        for kernel, c in sorted(counts.items()):
            log(f"  sass {name}: {kernel}: {c['HGMMA']} HGMMA, "
                f"{c['HMMA']} HMMA")
            if kernel.startswith(TENSOR_CORE_KERNELS[name]) \
                    and not tensor_core_ok(kernel, c):
                raise RuntimeError(f"{kernel} holds no tensor-core "
                                   "instruction its regime needs")
        for prefix in TENSOR_CORE_KERNELS[name]:
            if not any(k.startswith(prefix) for k in counts):
                raise RuntimeError(f"no {prefix} in the SASS of {name}")
    # the expert kernel overlaps its unpack with wgmmas: ptxas must not have
    # serialized them (C7514 or any other line of that family)
    serialized = [line for line in
                  _cuda.build_logs.get("int4_expert_matmul", "").splitlines()
                  if "C7514" in line or ("wgmma" in line
                                         and "serialized" in line)]
    if serialized:
        raise RuntimeError("csrc/int4_expert_matmul.cu: ptxas serialized "
                           "the wgmmas: " + "; ".join(serialized))
    unpack_mix = sass_unpack_mix(_cuda.load("int4_expert_matmul")._name,
                                 "int4_expert_matmul_kernel")
    for kernel, mix in sorted(unpack_mix.items()):
        per = ("no q4 read found" if mix["per_byte"] is None
               else f"{mix['per_byte']:.2f} a byte")
        log(f"  sass unpack {kernel}: {mix['unpack_instructions']} "
            f"instructions for {mix['q4_bytes']} q4 bytes a thread, {per} "
            f"({mix['ops']})")
    log("  nvcc (sm_90a, in parallel) " + ", ".join(
        f"csrc/{n}.cu {nvcc_s[n]:.1f} s" for n in sources)
        + f"; Triton rms_norm {triton_s:.1f} s")

    log("phase kernels (bf16 on the card, compared in f32)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    decode_lengths = [1, 17, 300, 511, 1024, 1500, 1999, 2048]
    attn = {kind: [] for kind in PAGED_KINDS}
    for kind, single, _ in ((k, v[1], v[2]) for k, v in PAGED_KINDS.items()):
        attn[kind].append(attention_case(torch, F, dev, flush, kind,
                                         "decode K=1 B=8", 8, 1,
                                         decode_lengths))
        if single:
            continue
        attn[kind].append(attention_case(
            torch, F, dev, flush, kind, "K=4 B=8", 8, 4,
            [4, 40, 333, 700, 1029, 1600, 1999, 2048]))
        # the verify width of --speculate 4
        attn[kind].append(attention_case(
            torch, F, dev, flush, kind, "verify K=5 B=8", 8, 5,
            [5, 41, 334, 705, 1029, 1605, 1999, 2048]))
        attn[kind].append(attention_case(torch, F, dev, flush, kind,
                                         "prefill K=1024 B=1", 1, 1024,
                                         [100 + 1024]))
    log("phase 3 (7f): the paged kernels at Gemma-7B's heads (16/16 of "
        "256), Qwen2-7B's (28/4) and Mistral-7B's window of 4096")
    for kind in ("paged_attention_multi", "paged_attention_multi_quant"):
        for tag, heads, cases in (
                ("gemma-7b", GEMMA_HEADS,
                 (("decode K=1 B=8", 8, 1, decode_lengths),
                  ("verify K=5 B=8", 8, 5,
                   [5, 41, 334, 705, 1029, 1605, 1999, 2048]),
                  ("prefill K=1024 B=1", 1, 1024, [100 + 1024]))),
                ("qwen2-7b", QWEN2_HEADS,
                 (("decode K=1 B=8", 8, 1, decode_lengths),
                  ("prefill K=1024 B=1", 1, 1024, [100 + 1024]))),
                ("mistral-7b window 4096", WINDOW_HEADS,
                 (("decode K=1 B=8", 8, 1, WINDOW_LENGTHS),
                  ("prefill K=1024 B=1", 1, 1024, [5000])))):
            for name, b, kq, lengths in cases:
                attn[kind].append(attention_case(
                    torch, F, dev, flush, kind, f"{tag} {name}", b, kq,
                    lengths, heads=heads))
    log("phase 3 (7g): the paged kernels at Gemma 2's heads (16/8 of 256) "
        "with its score soft cap of 50")
    for kind in ("paged_attention_multi", "paged_attention_multi_quant"):
        for name, b, kq, lengths in (
                ("decode K=1 B=8", 8, 1, decode_lengths),
                ("prefill K=1024 B=1", 1, 1024, [100 + 1024])):
            attn[kind].append(attention_case(
                torch, F, dev, flush, kind, f"soft cap 50 {name}", b, kq,
                lengths, heads=GEMMA2_HEADS))
    mla = {kind: [] for kind in MLA_KINDS}
    for kind, (_, single, _) in MLA_KINDS.items():
        mla[kind].append(mla_case(torch, F, dev, flush, kind,
                                  "decode K=1 B=8", 8, 1, MLA_DECODE_LENGTHS))
        if not single:
            mla[kind].append(mla_case(torch, F, dev, flush, kind,
                                      "prefill K=1024 B=1", 1, 1024,
                                      [100 + 1024]))
    log("phase 3 (7v): the MLA kernels at DeepSeek-V2-Lite's 16 heads")
    for kind in ("paged_attention_multi_mla",
                 "paged_attention_multi_mla_quant"):
        for name, b, kq, lengths in (
                ("decode K=1 B=8", 8, 1, MLA_DECODE_LENGTHS),
                ("prefill K=1024 B=1", 1, 1024, [100 + 1024])):
            mla[kind].append(mla_case(torch, F, dev, flush, kind,
                                      f"{DS_MODEL} 16 heads {name}", b, kq,
                                      lengths, hq=DS_HEADS))
    gc.collect()
    torch.cuda.empty_cache()
    int4 = [int4_case(torch, dev, flush, rows, kin, out, leaves)
            for rows in (8, 1024) for kin, out, leaves in INT4_SHAPES]
    int4 += [int4_case(torch, dev, flush, rows, kin, out, leaves)
             for rows in (8, 1024) for kin, out, leaves in INT4_70B_SHAPES]
    int4 += [int4_case(torch, dev, flush, rows, kin, out, leaves)
             for rows in (8, 1024) for kin, out, leaves in INT4_GEMMA3_SHAPES]
    int4 += [int4_case(torch, dev, flush, rows, kin, out, leaves)
             for rows in (8, 1024) for kin, out, leaves in INT4_DS_SHAPES]
    gc.collect()
    torch.cuda.empty_cache()
    int4_experts = [int4_expert_case(torch, dev, flush, rows, path, kin, out,
                                     leaves)
                    for rows, path in INT4_EXPERT_ROWS
                    for kin, out, leaves in INT4_EXPERT_SHAPES]
    log("phase 3 (7v): int4_expert_matmul at DeepSeek-V2-Lite's 64 experts "
        "of 1408, top-6")
    int4_experts += [int4_expert_case(torch, dev, flush, rows, path, kin, out,
                                      leaves, DS_EXPERTS, DS_TOP_K, DS_WIDTH)
                     for rows, path in ((8, "decode"), (1024, "prefill"))
                     for kin, out, leaves in INT4_DS_EXPERT_SHAPES]
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 7t (a): int4_matmul_sharded (row 15) on in-process tensor "
        "meshes of 2 and 4 shards")
    int4_sharded = [int4_sharded_case(torch, dev, flush, rows, n, kin, out,
                                      leaves)
                    for n in (2, 4) for rows in (8, 1024)
                    for kin, out, leaves in INT4_SHARDED_SHAPES[n]]
    gc.collect()
    torch.cuda.empty_cache()
    rms = [rms_case(torch, F, dev, flush, (rows, 4096)) for rows in (8, 1024)]
    # the other families' widths: Gemma-7B's 3072 and Qwen2-7B's 3584 (not
    # powers of two: the masked block), and Qwen3-8B's q/k norm, 8 slots x
    # 32 heads of 128
    rms += [rms_case(torch, F, dev, flush, shape)
            for shape in ((1024, 3072), (1024, 3584), (8, 32, 128))]
    # Gemma 3's width, and its q/k norm over a 1024-token chunk's 16 heads
    # of 256
    rms += [rms_case(torch, F, dev, flush, shape)
            for shape in ((1024, 3840), (1024, 16, 256))]
    # DeepSeek-V2-Lite's width and its latent's (c_norm over 512)
    rms += [rms_case(torch, F, dev, flush, shape)
            for shape in ((1024, 2048), (1024, 512))]
    # the training path's shape: x (8, 2048, 4096) needing gradients
    rms.append(rms_case(torch, F, dev, flush, (8, 2048, 4096), grad=True))

    log("phase flash kernels (bf16 on the card, compared in f32)")
    flash = [flash_case(torch, F, dev, flush, *case) for case in FLASH_CASES]
    flash += [flash_case(torch, F, dev, flush, *case)
              for case in FLASH_OFFSET_CASES]
    del flush
    gc.collect()
    torch.cuda.empty_cache()

    log("phase engine (llama3-8b, 8 slots, cache_len 2048)")
    from k8s_runpod_kubelet_tpu_torch.models import init_params, llama3_8b

    cfg = llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  random bf16 init in {init_s:.1f} s")
    eng, bf16_logits = engine_phase(torch, dev, card, cfg, params)
    eng["init_s"] = init_s
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7x (observability): phase 4's llama3-8b bf16 tree behind "
        "serve_main (/metrics, request spans with a JSONL export, "
        "/debug/profile) and a ReplicaReporter at 0.5 s against a stub "
        "router")
    obs = observability_phase(torch, dev, card, cfg, params, eng)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7k (disaggregated serving): phase 4's llama3-8b bf16 tree as "
        "prefill, decode and unified replicas: the device rung in this "
        "process, the wire, shm and pull rungs between two serve_main "
        "processes, --kv-int8 over the wire, the rungs' times")
    disagg = disagg_phase(torch, dev, card, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7g (d): llama3-8b --prefix-cache off (the contiguous decode "
        "loop over a linear cache, 8 slots, cache_len 2048; phase 4's tree)")
    prefix_off = interleave_engine_run(torch, dev, card, "llama3-8b", 2048,
                                       False, *PREFIX_OFF_LONG, params,
                                       ("--prefix-cache", "off"))

    log("phase recorder overhead (phase 4's burst, flight recorder off, "
        "on, on, off)")
    eng["recorder_turns"] = recorder_overhead_phase(torch, dev, card, cfg,
                                                    params)

    log("phase speculative engine (llama3-8b bf16, 8 slots, cache_len 2048, "
        f"speculate_k {SPEC_K}, serving_chunk_tokens {SPEC_CHUNK})")
    spec = spec_engine_phase(torch, dev, card, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase OpenAI front (llama3-8b bf16, 2 slots, cache_len 2048, "
        "kv_pool_pages 256, byte tokenizer)")
    openai = openai_phase(torch, dev, card, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase hf load (llama3-8b widths, {HF_LAYERS} layers, 2 "
        "safetensors shards)")
    hf = hf_load_phase(torch, dev, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7t (c): tensor-parallel engine (llama3-8b bf16 "
        "--tensor-parallel 4 in one process, 8 slots, cache_len 2048)")
    tp_bf16 = tp_engine_phase(torch, dev, card, cfg, params, bf16_logits,
                              tensor=4, quant=False)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7l: multi-LoRA engine (llama3-8b bf16 --lora-rank "
        f"{LORA_RANK} over all seven targets, --max-adapters "
        f"{LORA_MAX_ADAPTERS}, 8 slots, cache_len 2048)")
    lora_ads = lora_adapters(torch, cfg, params, dev,
                             burst_prompts(cfg)[1][2])
    lora = lora_engine_phase(torch, dev, card, cfg, params,
                             lora_ads["adapters"])
    lora["adapters"] = {k: lora_ads[k] for k in ("sigma", "moves",
                                                 "sigma_tried")}
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 7l (d): step_profile's LoRA profile (llama3-8b bf16, rank "
        f"{LORA_RANK}, all seven targets)")
    lora["profile"] = lora_profile_phase(torch, dev, card, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase quantized engine (llama3-8b --int4 --kv-int8, 8 slots, "
        "cache_len 2048)")
    box = [params]
    del params
    qeng, qparams, qlogits = quant_engine_phase(torch, dev, card, cfg, box,
                                                eng, bf16_logits)
    del box, bf16_logits
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7t (b): tensor-parallel engine (llama3-8b --int4 --kv-int8 "
        "--tensor-parallel 2 in one process, 8 slots, cache_len 2048)")
    tp_int4 = tp_engine_phase(torch, dev, card, cfg, qparams, qlogits,
                              tensor=2, quant=True)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 7l (e): multi-LoRA engine (llama3-8b --int4 --kv-int8 "
        f"--lora-rank {LORA_RANK} over all seven targets, 8 slots, "
        "cache_len 2048, 32 layers)")
    lora_q = lora_engine_phase(torch, dev, card, cfg, qparams,
                               lora_ads["adapters"], quant=True)
    del qparams, qlogits, lora_ads
    gc.collect()
    torch.cuda.empty_cache()

    log("phase MLA engine (mla-8b, bf16 latents, 8 slots, cache_len 2048)")
    from k8s_runpod_kubelet_tpu_torch.models import mla_8b

    mcfg = mla_8b()
    t0 = time.perf_counter()
    box = [init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)]
    torch.cuda.synchronize()
    mla_init_s = time.perf_counter() - t0
    log(f"  random bf16 init in {mla_init_s:.1f} s")
    mla_eng, mla_logits = mla_engine_phase(torch, dev, card, mcfg, box,
                                           kv_int8=False)
    mla_eng["init_s"] = mla_init_s
    gc.collect()
    torch.cuda.empty_cache()
    log("phase MLA engine (mla-8b --kv-int8: int8 latents, 8 slots, "
        "cache_len 2048)")
    mla_q, _ = mla_engine_phase(torch, dev, card, mcfg, box, kv_int8=True,
                                bf16_logits=mla_logits)
    del box, mla_logits
    gc.collect()
    torch.cuda.empty_cache()

    log("phase MoE engine (mixtral-8x7b --int4, 8 slots, cache_len 2048)")
    moe = moe_engine_phase(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 7v (DeepSeek-V2-Lite): {DS_MODEL} at full width and depth, "
        "bf16 and --int4 --kv-int8 on the paged loop (8 slots, cache_len "
        "2048), the dense route, embed, --prefix-cache off, the profile")
    deepseek = deepseek_phase(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7f: the other dense families at full width and depth "
        f"({', '.join(FAMILY_MODELS)}; 8 slots, cache_len 2048)")
    families = families_phase(torch, dev, card)
    log("phase 7f (70b): llama3-70b --int4 --kv-int8 on one card (8 slots, "
        "cache_len 2048)")
    big = llama70b_phase(torch, dev, card)
    log("phase 7g: Gemma 2 and 3 on the contiguous decode loop (8 slots; "
        "gemma2-9b at cache_len 8192, gemma3-12b at 4096 in bf16 and "
        "--int4 --kv-int8)")
    interleave = interleave_phase(torch, dev, card)
    interleave["llama3_8b_prefix_cache_off"] = prefix_off

    log("phase train (llama3-8b widths, 4 layers, batch 8 x seq 2048)")
    train = train_phase(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase MLA train (mla-8b widths, 4 layers, batch 8 x seq 2048, "
        "flash at D = 192)")
    train_mla = train_phase(torch, dev, card,
                            dataclasses.replace(mla_8b(), n_layers=4))
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase ring train (llama3-8b widths, 4 layers, batch {RING_BATCH} "
        f"x seq {RING_SEQ} in {RING_SHARDS} sequence shards, ring_flash)")
    ring_train = ring_train_phase(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase MLA ring train (mla-8b widths, 4 layers, batch {RING_BATCH} "
        f"x seq {RING_SEQ} in {RING_SHARDS} sequence shards, ring_flash: "
        "the flash kernels at D = 192 and q_offset)")
    ring_train_mla = ring_train_phase(
        torch, dev, card, dataclasses.replace(mla_8b(), n_layers=4), steps=4)

    log("phase train_main (--model tiny, checkpoint and resume)")
    train_cli = train_main_phase(torch)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 9f (fine-tune and telemetry): (a) the fused loss and (b) "
        f"remat dots at llama3-8b widths, 4 layers, batch 8 x 2048; (c)-(f) "
        f"a LoRA r={FT_RANK} fine-tune of llama3-8b at full depth through "
        f"train_main (batch {FT_BATCH} x {FT_SEQ}, {FT_STEPS} steps from a "
        f"token file, async checkpoints every {FT_EVERY}, telemetry), its "
        f"resume, and its adapter served")
    fused_dots = fused_and_dots_phase(torch, dev, card)
    finetune = finetune_phase(torch, dev, card)
    finetune["fused_and_dots"] = fused_dots
    ft = finetune["finetune"]
    log(f"  [{card}] per layer and 1k tokens: the LoRA fine-tune "
        f"{ft['step_s_median'] / 32 / (FT_BATCH * FT_SEQ) * 1e6:.3f} ms "
        f"(telemetry on, frozen base, fused loss) against phase 9's full "
        f"step {train['step_s_median'] / train['layers'] / (train['batch'] * train['seq_len']) * 1e6:.3f} ms")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 9e (MoE training): (a) mixtral-8x7b and (b) "
        f"deepseek-v2-lite widths at reduced depth, batch 8 x 2048, the "
        f"latter with the fused loss; (c) a LoRA r={FT_RANK} fine-tune of "
        f"{MOE_FT_MODEL} at full depth through train_main")
    moe_train = moe_train_phase(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 9g (Gemma training): (a) rows 1-3, 12 and 16 at Gemma's "
        "shapes, (b) gemma2-9b and gemma3-12b widths at reduced depth, "
        f"batch 1 x {GEMMA_TRAIN_SEQ}, (e) the seq = 2 Gemma 2 step, (c) a "
        f"LoRA r={FT_RANK} fine-tune of the whole gemma2-9b through "
        "train_main and (d) its adapter served on the contiguous loop")
    gemma = gemma_train_phase(torch, F, dev, card)
    flex_waited = _FLEX_WARM.get("waited_s", 0.0)
    stop_flex_warm()
    log(f"  flex_attention's compiles made ahead by --flex-warm: waited "
        f"{flex_waited:.1f} s for them")

    def record(name, route, source, replaces, cases, launches, by_path,
               library_call):
        head = cases[0]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "library_call": library_call, "case": head["case"],
                "cases": cases}

    def flash_cases(kname):
        return [{"case": c["case"], **c["kernels"][kname]}
                for c in flash + gemma["kernels"]["flash"]]

    def finetune_paths(kname) -> dict:
        """Phase 9f's and 9e's launches of ``kname`` by run."""
        runs = fused_dots["runs"]
        return {"train_naive_loss": runs["naive"]["launches"][kname],
                "train_fused_loss": runs["fused"]["launches"][kname],
                "train_dots": runs["fused_dots"]["launches"][kname],
                "finetune_lora": finetune["finetune"]["launches"][kname],
                "train_mixtral": moe_train["mixtral"]["launches"][kname],
                "train_deepseek": moe_train["deepseek"]["launches"][kname],
                "finetune_deepseek_lora":
                    moe_train["finetune"]["launches"][kname],
                "train_gemma2": gemma["gemma2_9b"]["launches"][kname],
                "train_gemma3": gemma["gemma3_12b"]["launches"][kname],
                "train_gemma2_seq2": gemma["seq2"]["launches"][kname],
                "finetune_gemma2_lora":
                    gemma["finetune"]["launches"][kname]}

    def family_paths(kname) -> dict:
        """Phase 7f's launches of ``kname`` by engine run."""
        runs = {f"serve_{name}" + ("" if mode == "bf16" else f"_{mode}"):
                rec[mode]["launches"]
                for name, rec in families.items()
                for mode in ("bf16", "int4_kv_int8") if mode in rec}
        runs["serve_llama3_70b_int4_kv_int8"] = big["launches"]
        runs.update({f"serve_contiguous_{key}": rec["launches"]
                     for key, rec in interleave.items() if "launches" in rec})
        spec_tp = interleave["gemma2_9b_spec_tp"]
        runs["serve_contiguous_gemma2_9b_spec"] = spec_tp["spec"]["counts"]
        runs[f"serve_contiguous_gemma2_9b_tp{TP7G}"] = spec_tp["tp"]["counts"]
        return {path: n[kname] for path, n in runs.items() if kname in n}

    def deepseek_paths(kname) -> dict:
        """Phase 7v's launches of ``kname`` by engine run."""
        runs = {"serve_deepseek": deepseek["bf16"]["launches"],
                "serve_deepseek_int4_kv_int8":
                    deepseek["int4_kv_int8"]["launches"],
                f"serve_deepseek_ep{EP7V}_int4_kv_int8":
                    deepseek["ep"]["launches"],
                "serve_deepseek_dense":
                    deepseek["dense_and_contiguous"]["launches"],
                "serve_disagg_deepseek_int4_kv_int8":
                    deepseek["handoff"]["launches"]}
        return {path: n[kname] for path, n in runs.items() if kname in n}

    serve_launches, quant_launches = eng["launches"], qeng["launches"]
    tp_launches, tp4_launches = tp_int4["launches"], tp_bf16["launches"]
    moe_launches = moe["launches"]
    moe_ep_launches = moe["ep_tp"]["launches"]
    spec_launches = spec["runs"]["speculative"]["counts"]
    lora_launches, lora_q_launches = lora["launches"], lora_q["launches"]
    mla_launches, mla_q_launches = mla_eng["launches"], mla_q["launches"]
    mla_dense, mla_q_dense = mla_eng["dense_route"], mla_q["dense_route"]
    csrc = "k8s_runpod_kubelet_tpu_torch/csrc/"
    jax_attn = "k8s_runpod_kubelet_tpu/ops/attention.py:"
    sdpa = "SDPA over the gathered (dequantized) K/V, same mask"
    kernels = [
        record("paged_attention_multi", "cuda",
               csrc + "paged_attention_multi.cu", jax_attn + "1524",
               attn["paged_attention_multi"],
               serve_launches["paged_attention_multi"],
               {"serve": serve_launches["paged_attention_multi"],
                "serve_observability":
                    obs["launches"]["paged_attention_multi"],
                "serve_disagg_device":
                    disagg["device"]["launches"]["paged_attention_multi"],
                "serve_spec": spec_launches["paged_attention_multi"],
                "serve_openai": openai["launches"]["paged_attention_multi"],
                "serve_int4_kv_int8":
                    quant_launches["paged_attention_multi"],
                "serve_moe": moe_launches["paged_attention_multi"],
                "serve_moe_ep2_tp2": moe_ep_launches["paged_attention_multi"],
                "serve_tp4_bf16": tp4_launches["paged_attention_multi"],
                "serve_tp": tp_launches["paged_attention_multi"],
                "serve_lora": lora_launches["paged_attention_multi"],
                "serve_lora_int4_kv_int8":
                    lora_q_launches["paged_attention_multi"],
                **family_paths("paged_attention_multi")}, sdpa),
        record("rms_norm", "triton",
               "k8s_runpod_kubelet_tpu_torch/ops/rmsnorm.py",
               "k8s_runpod_kubelet_tpu/ops/rmsnorm.py:80",
               rms + gemma["kernels"]["rms_norm"],
               serve_launches["rms_norm"],
               {"serve": serve_launches["rms_norm"],
                "serve_observability": obs["launches"]["rms_norm"],
                "serve_disagg_device": disagg["device"]["launches"]["rms_norm"],
                "serve_disagg_kv_int8": disagg["kv_int8"]["launches"]["rms_norm"],
                "serve_spec": spec_launches["rms_norm"],
                "serve_int4_kv_int8": quant_launches["rms_norm"],
                "serve_mla": mla_launches["rms_norm"],
                "serve_mla_kv_int8": mla_q_launches["rms_norm"],
                "serve_openai": openai["launches"]["rms_norm"],
                "serve_moe": moe_launches["rms_norm"],
                "serve_moe_ep2_tp2": moe_ep_launches["rms_norm"],
                "serve_tp": tp_launches["rms_norm"],
                "serve_tp4_bf16": tp4_launches["rms_norm"],
                "serve_lora": lora_launches["rms_norm"],
                "serve_lora_int4_kv_int8": lora_q_launches["rms_norm"],
                "serve_mla_dense": mla_dense["launches"]["rms_norm"],
                "serve_mla_kv_int8_dense":
                    mla_q_dense["launches"]["rms_norm"],
                **deepseek_paths("rms_norm"),
                "train": train["launches"]["rms_norm"],
                "train_mla": train_mla["launches"]["rms_norm"],
                "train_ring": ring_train["launches"]["rms_norm"],
                "train_ring_mla": ring_train_mla["launches"]["rms_norm"],
                **finetune_paths("rms_norm"),
                "serve_gemma2_lora_contiguous":
                    gemma["serve"]["launches"]["rms_norm"],
                **family_paths("rms_norm")},
               "F.rms_norm, bf16 weight"),
    ] + [
        record(kname, "cuda", csrc + "flash_attention.cu",
               replaces, flash_cases(kname), train["launches"][kname],
               {"train": train["launches"][kname],
                "train_mla": train_mla["launches"][kname],
                "train_ring": ring_train["launches"][kname],
                "train_ring_mla": ring_train_mla["launches"][kname],
                **finetune_paths(kname),
                "serve_mla_dense": mla_dense["launches"][kname],
                "serve_mla_kv_int8_dense": mla_q_dense["launches"][kname],
                **deepseek_paths(kname),
                **({k: v for k, v in family_paths(kname).items()
                    if k.startswith("serve_contiguous_")}),
                **({"serve_openai": openai["launches"][kname]}
                   if kname in openai["launches"] else {}),
                **({"serve_lora_dense_group": lora["dense_group"][kname],
                    "serve_lora_int4_kv_int8_dense_group":
                        lora_q["dense_group"][kname],
                    "serve_gemma2_lora_contiguous":
                        gemma["serve"]["launches"][kname]}
                   if kname == "flash_fwd" else {})}, library_call)
        for kname, replaces, library_call in (
            ("flash_fwd", jax_attn + "199", "SDPA forward, under a soft "
             "cap compiled flex_attention's (at D = 192 a yardstick on the "
             "same padded q/k/v)"),
            ("flash_dq", jax_attn + "360",
             "SDPA (under a soft cap compiled flex_attention) autograd "
             "backward: dq, dk and dv together"),
            ("flash_dkv", jax_attn + "397",
             "SDPA (under a soft cap compiled flex_attention) autograd "
             "backward: dq, dk and dv together"))
    ] + [
        record("paged_attention_multi_quant", "cuda",
               csrc + "paged_attention_multi_quant.cu", jax_attn + "1741",
               attn["paged_attention_multi_quant"],
               quant_launches["paged_attention_multi_quant"],
               {"serve_int4_kv_int8":
                    quant_launches["paged_attention_multi_quant"],
                "serve_disagg_kv_int8": disagg["kv_int8"]["launches"][
                    "paged_attention_multi_quant"],
                "serve_tp": tp_launches["paged_attention_multi_quant"],
                "serve_lora_int4_kv_int8":
                    lora_q_launches["paged_attention_multi_quant"],
                **family_paths("paged_attention_multi_quant")},
               sdpa + " (a yardstick: no single PyTorch call reads int8 "
               "pages)"),
        record("int4_matmul", "cuda", csrc + "int4_matmul.cu",
               "k8s_runpod_kubelet_tpu/ops/int4_matmul.py:64", int4,
               quant_launches["int4_matmul"],
               {"serve_int4_kv_int8": quant_launches["int4_matmul"],
                "serve_moe": moe_launches["int4_matmul"],
                "serve_tp": tp_launches["int4_matmul"],
                "serve_lora_int4_kv_int8": lora_q_launches["int4_matmul"],
                **deepseek_paths("int4_matmul"),
                **family_paths("int4_matmul")},
               "torch.ops.aten._weight_int4pack_mm on the same nibbles and "
               "bf16 group scales (yardstick_ms: torch.matmul by the "
               "dequantized bf16 weight)"),
        record("int4_matmul_sharded", "cuda", csrc + "int4_matmul.cu",
               "k8s_runpod_kubelet_tpu/ops/int4_matmul.py:157", int4_sharded,
               tp_launches["int4_matmul_sharded"],
               {"serve_tp": tp_launches["int4_matmul_sharded"],
                "serve_tp4_bf16": tp4_launches["int4_matmul_sharded"],
                "serve_moe_ep2_tp2": moe_ep_launches["int4_matmul_sharded"]},
               "torch.ops.aten._weight_int4pack_mm on the gathered weight "
               "(the same function; yardsticks: the same call once a "
               "shard, int4_matmul on the gathered weight and on one "
               "shard's slice)"),
        record("int4_expert_matmul", "cuda", csrc + "int4_expert_matmul.cu",
               "k8s_runpod_kubelet_tpu/ops/int4_matmul.py:181",
               int4_experts, moe_launches["int4_expert_matmul"],
               {"serve_moe": moe_launches["int4_expert_matmul"],
                "serve_moe_ep2_tp2": moe_ep_launches["int4_expert_matmul"],
                **deepseek_paths("int4_expert_matmul")},
               "none: no single PyTorch call reads int4 experts "
               "(yardstick_ms: torch.bmm by the dequantized bf16 experts)"),
    ] + [
        # the single-token forms: no model path calls them in either
        # package (decode runs the multi-token kernels at K = 1); their
        # counts are read from both bursts, which hold them at 0
        record(kname, "cuda", csrc + source, jax_attn + line, attn[kname],
               serve_launches[kname] + quant_launches[kname],
               {"serve": serve_launches[kname],
                "serve_int4_kv_int8": quant_launches[kname]}, library_call)
        for kname, source, line, library_call in (
            ("paged_attention", "paged_attention_multi.cu", "608", sdpa),
            ("paged_attention_quant", "paged_attention_multi_quant.cu",
             "884", sdpa + " (a yardstick: no single PyTorch call reads "
             "int8 pages)"))
    ]
    mla_sdpa = ("SDPA over the gathered latents in bf16, q = [q_lat, "
                "q_rope], k = [c, kr], v = c, one kv head (enable_gqa), "
                "same mask")
    kernels += [
        record("paged_attention_multi_mla", "cuda",
               csrc + "paged_attention_multi_mla.cu", jax_attn + "1932",
               mla["paged_attention_multi_mla"],
               mla_launches["paged_attention_multi_mla"],
               {"serve_mla": mla_launches["paged_attention_multi_mla"],
                "serve_mla_kv_int8":
                    mla_q_launches["paged_attention_multi_mla"],
                "serve_mla_dense":
                    mla_dense["launches"]["paged_attention_multi_mla"],
                "serve_mla_kv_int8_dense":
                    mla_q_dense["launches"]["paged_attention_multi_mla"],
                **deepseek_paths("paged_attention_multi_mla")},
               mla_sdpa),
        record("paged_attention_multi_mla_quant", "cuda",
               csrc + "paged_attention_multi_mla_quant.cu", jax_attn + "2105",
               mla["paged_attention_multi_mla_quant"],
               mla_q_launches["paged_attention_multi_mla_quant"],
               {"serve_mla": mla_launches["paged_attention_multi_mla_quant"],
                "serve_mla_kv_int8":
                    mla_q_launches["paged_attention_multi_mla_quant"],
                "serve_mla_dense":
                    mla_dense["launches"]["paged_attention_multi_mla_quant"],
                "serve_mla_kv_int8_dense": mla_q_dense["launches"][
                    "paged_attention_multi_mla_quant"],
                **deepseek_paths("paged_attention_multi_mla_quant")},
               mla_sdpa + " over the dequantized latents (a yardstick: no "
               "single PyTorch call reads int8 latents)"),
    ] + [
        # the single-token MLA forms: no model path calls them (decode runs
        # the multi-token kernels at K = 1); counted in both MLA bursts,
        # which hold them at 0
        record(kname, "cuda", csrc + source, jax_attn + line, mla[kname],
               mla_launches[kname] + mla_q_launches[kname],
               {"serve_mla": mla_launches[kname],
                "serve_mla_kv_int8": mla_q_launches[kname]}, library_call)
        for kname, source, line, library_call in (
            ("paged_attention_mla", "paged_attention_multi_mla.cu", "1078",
             mla_sdpa),
            ("paged_attention_mla_quant", "paged_attention_multi_mla_quant.cu",
             "1269", mla_sdpa + " over the dequantized latents (a "
             "yardstick: no single PyTorch call reads int8 latents)"))
    ]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "device": device, "kernels": kernels,
                       "flash": flash, "engine": eng,
                       "observability": obs, "disagg": disagg,
                       "spec_engine": spec, "openai": openai,
                       "hf_load": hf,
                       "quant_engine": qeng, "mla_engine": mla_eng,
                       "int4_sharded": int4_sharded,
                       "tp_engine_int4": tp_int4, "tp_engine_bf16": tp_bf16,
                       "lora_engine": lora, "lora_engine_int4_kv_int8": lora_q,
                       "mla_kv_int8_engine": mla_q, "moe_engine": moe,
                       "deepseek": deepseek,
                       "train": train, "train_mla": train_mla,
                       "ring_train": ring_train,
                       "ring_train_mla": ring_train_mla,
                       "train_main": train_cli, "finetune": finetune,
                       "moe_train": moe_train, "gemma_train": gemma,
                       "families": families,
                       "llama3_70b": big, "interleave": interleave,
                       "build_s": {**nvcc_s, "triton": triton_s},
                       "flex_warm_waited_s": flex_waited,
                       "sass": sass, "int4_expert_unpack_mix": unpack_mix},
                      f, indent=1)
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
