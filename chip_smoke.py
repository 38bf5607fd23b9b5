#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the root of a checkout

It drives the port's two entry points end to end and checks them:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and prints the
   ``ptxas`` reports (registers, shared memory, spills) of flash
   attention, SSD chunk and their backwards on a JSON line each; fails
   if a tile flash forward kernel (fp32 or bf16) of ``FORWARD_NO_SPILL``,
   a flash backward kernel (fp32 or bf16) of ``BACKWARD.NO_SPILL`` or a
   one-query kernel of ``ONE_QUERY_NO_SPILL`` spills, and if the SASS of
   a tile forward kernel or of any backward kernel, fp32 or bf16
   (``cuobjdump -sass``, a ``sass_mma_counts`` line each), holds an
   ``HMMA`` or no ``HGMMA``, or a ``mma.sync`` forward kernel
   (``flash_attention_kernel``) is left;
3. builds Mixtral-8x7B at its full published widths (d_model 4096,
   32 heads / 8 KV heads, expert d_ff 14336, 8 experts top-2, vocab
   32000) with the depth cut to 2 layers, fp32, random weights drawn on
   the card from a seeded generator; the expert masters go to pinned
   host memory one expert at a time;
4. offload serving: serves 4 staggered requests (32-token prompts, 16
   greedy tokens each) through ``ContinuousOffloadServer`` (LFU cache of
   4 slots a layer, speculative prefetch, max_batch 4, paged KV in
   16-token blocks), with every kernel's launch count reset just before
   and read just after, and checks each request's tokens against
   ``OffloadEngine.generate`` (dense KV, plain attention) and the last
   logits for finite values of the right shape. Each step's
   host-to-device expert bytes must equal the (misses + prefetches) of
   the trace rows it added times the stored bytes of one expert, and
   every install must run on the compute stream (``overlap=False``) or
   on the engine's copy stream (``overlap=True``). The same workload
   then runs with ``overlap=True`` on the same pinned masters: the same
   tokens, functional trace rows, ``stats()`` off the simulated-clock
   keys and per-step bytes, every slot bitwise at the end, and both
   runs' step times on one ``overlap_serving`` line;
4b. the same serving runs (overlap off, then on) with ``quant="int8"``:
   int8 masters and their scale rows pinned, copied as they are and
   dequantized on the card; ``ExpertStore.fetch`` (the host dequant) is
   never called while serving or generating, server tokens ==
   ``generate``, bytes per step as above, and every resident slot
   bitwise the host dequant;
4c. the int8 masters once more with ``policy="learned"``,
   ``prefetch="learned"`` and ``overlap=True``, the model trained
   (``train_from_trace``) from the trace of step 4's first serving run:
   tokens == ``generate``, bytes per step as above, both kernels
   launched; its step times and cache counters beside the LFU +
   speculative overlap-on run's;
4d. memory tiers, on the same int8 masters: ``ContinuousOffloadServer``
   sized by one ``hbm_budget_bytes`` that the plan splits into 4 slots a
   layer and 4 KV blocks of 16 tokens (max_batch 2, 4-token prefill
   chunks), 3 requests of 24 seeded prompt tokens and 16 greedy tokens:
   the pool overcommits and the younger request's KV is parked in
   pinned host memory and resumed. Overlap off: tokens == ``generate``;
   overlap on: the same tokens, every step's logits, functional trace
   rows with ``miss_tiers``, tier events and ``stats()`` off the clock
   keys, and every park and resume copy on the engine's copy stream;
   ``_park_kv`` / ``_restore_kv`` run under
   ``torch.cuda.set_sync_debug_mode("error")``; replay
   (``resume_from_host=False``) gives the same tokens in more steps;
   half the masters on the simulated disk give the same tokens with
   disk fetches on the clock; bytes per step as above; parked bytes,
   slot buffer bytes and KV pool bytes against the plan; then sleeps
   before every park / resume copy and before every park's gather,
   which must change nothing, and the same sleeps with the resume's or
   the park's event wait taken out, which must change the logits. One
   ``tiers`` JSON line: park / resume counts, bytes and copy times,
   steps and step times against replay, the HBM plan beside the real
   bytes, labelled with the card;
5. the offload invariants on the card, each on 2 requests of 8 greedy
   tokens: ``overlap=True`` gives the tokens and every step's logits of
   ``overlap=False``, ``prefill_chunk=4`` the tokens of per-token
   prefill, and ``faults=FaultPlan.null()`` the tokens, ``stats()`` and
   trace of ``faults=None``; then the race checks on a 2-slot cache:
   ``torch.cuda._sleep`` before every install on the copy stream, and
   before every ``ops.moe_ffn`` on the compute stream, must leave tokens
   and logits bitwise those of ``overlap=False``, and the same sleeps
   with the matching event wait taken out must change the logits;
6. full-sequence prefill, Mixtral (the same weights): ``prefill`` of 2
   prompts of 2048 tokens through the default ``moe_path="auto"``
   (``moe_capacity`` without a mesh), then ``prefill(moe_path="dense")``
   of 2 prompts of 512 tokens against ``ServingEngine(moe_path="dense")
   .generate_batch`` on the same prompts (8 greedy tokens): the engine
   feeds the prompt token by token through ``decode_step``, so its
   logits at the last prompt position are held against the prefill's;
6d. the dry run's counter (``dryrun_phase``), on the same weights, with
   no mesh: one ``prefill`` of 2 x 2048 and one ``decode_step`` of 2
   rows over 4096 cache slots, each under ``op_cost.OpCost`` on the card
   and again on meta copies of the same tensors: the two reports must be
   equal field for field (FLOPs, bytes, collectives, kernel calls, the
   live bytes' peak) and the card run's kernel calls must equal its
   launch counts (reset just before, read just after); each call is then
   timed without the counter. Then ``python -m
   repro_torch.launch.dryrun`` in a subprocess with the card hidden
   (``CUDA_VISIBLE_DEVICES=""``: the dry run needs none) on
   Qwen1.5-0.5B x decode_32k and DeepSeek-V2 x prefill_32k (expert
   parallelism, flash at hd 192) on the (16, 16) mesh; each must end
   ``1 ok, 0 failed``. One ``dryrun`` JSON line: per call the counted
   work, the card's time, the achieved TFLOP/s and TB/s, the counted
   peak beside ``torch.cuda.max_memory_allocated``'s rise, and the two
   cases' results;
6a. the distributed paths at world size 1: one NCCL process group
   (``tcp://127.0.0.1`` on a port free at run time) and a (1, 1)
   ("data", "model") mesh on the card, the rules of the published archs
   (``sharding_rules``), the params cut by ``shard_params``. On the same
   Mixtral weights: (a) one MoE layer on 2 x 2048 seeded tokens, where
   ``moe_apply`` takes the expert-parallel path (its two
   ``all_to_all_single`` exchanges timed by CUDA events), bitwise
   ``moe_capacity`` without a mesh, both timed; (b) the tensor-parallel
   ``prefill`` of 2 x 2048 tokens (the rank's heads, all-reduces after
   ``wo`` and the FFNs, the embedding and logits gathered, EP in the
   MoE layers), bitwise ``prefill`` without a mesh, flash attention
   launched once a layer, its call held and timed (a ``kernels`` entry
   of its own); then, on DeepSeek-V2's weights at the end of 6b, (c) 8
   greedy ``decode_step``s of 2 rows with the latent and rope-key caches
   cut by ``shard_decode_state`` (sequence-sharded, the softmax combined
   across the model ranks) against the unsharded caches: tokens equal,
   logits within 1e-5 x max; on Jamba's weights at the end of its 6c
   phase, (d) its ``prefill`` of 2 x 2048 tokens under the mesh (the
   attention on the rank's heads, the SSM split by head, the MoE
   expert-parallel), bitwise the unsharded one, flash attention and SSD
   chunk launched once each and their calls held and timed; on Mamba2's
   weights at the end of phase 7, (e) its ``prefill`` of 2 x 2048 under
   the mesh (the SSD mixer split by head: its xBC columns handed to the
   heads by one ``all_to_all_single`` a layer, ``ssd_chunk`` on the
   rank's heads, the norm's mean of squares and ``out_proj``
   all-reduced), bitwise, SSD chunk once a layer, its call held and
   timed, then 8 greedy ``decode_step``s of 2 rows with the state cut by
   ``shard_decode_state`` against the unsharded state: tokens equal,
   logits within 1e-6 x max; at the end of Whisper-tiny's and
   Llama-3.2-Vision's 6c phases (f) under each one's published rules
   (Whisper-tiny's data parallel only, its weights whole; Vision's
   splitting heads and ff blocks), Whisper's ``encoder_forward`` over 2 x
   1500 frames (flash once an encoder layer) and each one's ``prefill``
   (2 x 448, 2 x 2048 over 1601 patches; the cross layers on the rank's
   heads over its rows of the encoder states), bitwise the unsharded
   ones, flash once a self-attention and once a cross layer, the
   heaviest self-attention and cross calls held and timed; then 8 greedy
   ``decode_step``s of 2 rows over a state built whole and cut by
   ``shard_decode_state`` (its cross K/V by rows and heads) against the
   unsharded state: tokens equal, logits within 1e-6 x max, flash once a
   cross layer a step, one more step's collectives counted; after
   Mamba2's, (g) ``make_train_step`` under the mesh for MESH_TRAIN_RUNS
   (Qwen1.5-0.5B whole on 2 x 2048, Mixtral 2 layers on 1 x 2048 with
   the expert-parallel path against the plain step's ``moe_capacity``,
   Mamba2 8 layers on 1 x 2048, Whisper-tiny whole on 2 x 448 over 1500
   frames; fp32, each collective differentiated by its transpose, the
   gradients summed over the unsplit axes, AdamW on the rank's blocks):
   two steps each way from the seeded params, the last step's loss,
   gradients and post-AdamW params bitwise the plain step's, the flash /
   SSD forward and backward launches and the collectives by kind exactly
   as counted (``mesh_step_collectives``), each kernel's heaviest call of
   the path held and timed (a ``kernels`` entry of its own), a step each
   way timed in TURNS; a ``mesh_train`` line a model; (h) ZeRO-1 for
   ZERO1_TRAIN_RUNS (Jamba-1.5-Large and DeepSeek-V2, one layer each at
   published widths, fp32 and bf16, 1 x 2048) with the moments of
   ``init_opt_state`` (cut on "data": at one rank each non-empty ZeRO-1
   leaf's gradient is reduce-scattered and its updated block
   all-gathered through NCCL, one block of all of it): two steps, each
   from the same state as a plain step run just before it (the state
   saved to pinned host buffers and swapped back), the loss, every
   gradient AdamW saw and every param and moment after each step bitwise
   the plain step's, launches as (g) counts them, collectives by kind as
   ``mesh_step_collectives`` counts them from the leaves' specs (one
   reduce-scatter and one all-gather a non-empty ZeRO-1 leaf), the card's
   peak and the pinned host bytes, a step each way timed in TURNS; a
   ``zero1_train`` line a model; on Mixtral's weights and phase 4's
   pinned masters, right after (b), (i) offload serving under the mesh:
   phase 4's workload through ``ContinuousOffloadServer`` built and run
   inside the mesh from the whole params (attention tensor-parallel on
   the rank's heads, ``paged_attention`` on its pool of KV heads, the
   experts whole), in TURNS against the plain server: tokens, functional
   trace rows, ``stats()`` with the simulated clock, per-step H2D bytes
   and every step's logits bitwise the plain run's, ``paged_attention``
   once a layer a step and ``moe_ffn`` as often as plain, the mesh run's
   calls of both held and timed (``kernels`` entries of their own), the
   collectives a step by kind; then the same with 4-token prefill
   chunks; a ``mesh_serving`` line; right after it, (j) memory tiers
   under the mesh: phase 4d's tiered workload (one HBM budget split into
   4 slots a layer and 4 KV blocks of 16, 3 requests of 24 + 16 tokens,
   4-token prefill chunks; the pool overcommits, KV is parked in pinned
   host memory and resumed) on the same fp32 masters, the tiered server
   built and run inside the mesh, in TURNS against the plain tiered
   server: tokens, every step's logits, trace rows with ``miss_tiers``,
   tier events, ``stats()`` with the clock, per-step H2D bytes, each
   park's snapshot and the arbiter's bytes for it bitwise or equal,
   ``paged_attention`` once a layer a step and ``moe_ffn`` as often as
   plain (the mesh run's calls held and timed), 4 collectives a step by
   kind; a ``tier_mesh_serving`` line with the step and park / resume
   copy times by turn. One ``distributed`` JSON line (world
   size, NCCL version, the twelve results, their times and the phase's
   seconds); then the group is destroyed. The group stays open from 6a
   to the end of phase 7;
6b. DeepSeek-V2 (MLA, 160 routed experts top-6 beside a shared SwiGLU of
   width 3072) at its full published widths (d_model 5120, 128 heads of
   hd 128, kv_lora_rank 512, rope key 64, expert d_ff 1536, vocab
   102400), depth cut to 2 of 60 layers, fp32, once Mixtral's params and
   masters are freed (``MemAvailable`` and the 30.2 GB of pinned masters
   on a JSON line first): the staggered serving workload with 32 slots a
   layer, LFU, speculative prefetch and paged latent KV — tokens ==
   ``generate``, bytes per step exact, ``moe_ffn`` launched for every
   layer of every step, ``paged_attention`` never (MLA's paged decode is
   plain PyTorch, as in the JAX package), finite [4, vocab] logits — then
   overlap on == off, the same workload's server built and run under the
   (1, 1) mesh (6a, i: the latent pool whole, the rank's heads) with the
   plain server's tokens, trace rows and ``stats()``, a
   ``deepseek_serving`` line (step times, H2D bytes, the smallest gap
   between the 6th and 7th router logit, the mesh run's), and phase 6's
   prefills: flash attention at q/k width 192 and v width 128 once a
   layer, the prefill against the absorbed-latent ``decode_step``;
6c. the hybrid, encdec and vlm families at their published widths, fp32,
   one at a time (``family_phase``): Jamba-1.5-Large (d_model 8192, 64
   heads / 8 KV heads of hd 128, no positional encoding, dense d_ff and
   16 experts top-2 of 24576, SSM state 128, headdim 64, 256 SSM heads,
   chunk 128, vocab 65536) cut to 2 of 72 layers in periods of 2 (one
   attention layer with a dense SwiGLU, one SSM layer with the MoE);
   Whisper-tiny whole (4 + 4 layers, d_model 384, 6 heads of 64, QKV
   biases, sinusoidal positions, vocab 51865): the encoder over 1500
   seeded frames launches flash attention once a layer, non-causal, and
   the decoder runs on its 448-token text context; Llama-3.2-Vision-11B
   (d_model 4096, 32 / 8 heads, d_ff 14336, vocab 128256) cut to one
   period of 40 layers (4 plain, 1 cross) over 1601 seeded patch
   embeddings. Each runs phase 6's prefills and engine comparison with
   ``enc=``; the engine launches flash attention once per cross layer
   per decode step (one query row), and nothing else, every launch on
   the one-query route (``ops.route_counts``); the engine's cross call is
   held and timed as a ``kernels`` entry of its own with the engine's
   launches, and checked against float64, bitwise on a second launch and
   row and head independent. After each of Whisper's and Vision's fp32
   phases the phase runs again, without the mesh, in the config's own
   bf16 (weights drawn in bf16, bf16 frames through the encoder or bf16
   patches; prefill vs decode logits within BF16_PREFILL_TOL x max):
   launches exact and every engine call on the bf16 one-query route, its
   entries marked "bfloat16" (the engine's call checked against float64
   within BF16_F64_TOL), the engine run again under ``torch.profiler``
   for its device busy time; a ``bf16_engine`` line (``engine_s``, launches,
   routes, ``profiled_engine``);
7. the same for Mamba2-2.7B at its full published widths (d_model 2560,
   d_inner 5120, 80 SSD heads x headdim 64, state 128, chunk 256, vocab
   50280), depth cut to 8 of 64 layers, fp32: prefill and engine on 2
   prompts of 512 tokens (2 chunks), then a timed prefill of 2 x 2048;
7b. training (``training_phase``): Qwen1.5-0.5B whole, one step through
   the kernels against the same step through the plain attention, in
   fp32 and in bf16 (``STEP_TOL``), then ``train()`` over ``TRAIN_RUNS``
   for Qwen1.5-0.5B (fp32), Qwen2.5-3B whole in its published bf16 (16
   query heads over 2 KV heads of 128), Mixtral-8x7B (2 layers),
   Mamba2-2.7B whole (64 layers at its published widths) and a reduced
   Jamba hybrid (attention and SSM layers): every step launches the flash
   forward twice and its backward once per attention layer, the SSD chunk
   forward twice and its backward once per SSM layer, and nothing else;
   losses finite and falling; each backward kernel held against its plain
   version and against float64 at each model's recorded call, and
   launched twice there for bitwise equal gradients, and the flash
   forward likewise at Qwen2.5-3B's (bf16) and Qwen1.5-0.5B's (fp32)
   call, each a ``kernels`` entry of its own; the kernels with no
   backward refuse inputs that require grad;
7c. the port's entry points as a user calls them (``launch_phase``):
   ``repro_torch.launch.train.main`` in-process on Qwen1.5-0.5B whole in
   its published bf16, 3 steps of 4 x 2048 with ``--ckpt``: exact flash
   launches a step, a finite final loss, the checkpoint loaded into an
   ``init_params`` tree equal to the trained params bitwise, and the flash
   backward held at its recorded bf16 call as in 7b;
   ``repro_torch.launch.serve.main`` at its own reduced sizes
   (offload LFU + speculative prefetch, with ``--overlap``, with
   ``--quant int8``, and ``--mode device``) with the launches the code
   implies, and once as ``python -m repro_torch.launch.serve`` in a
   subprocess, which must print the in-process run's tokens; the paper's
   pipeline (``repro_torch.examples.offload_paper_pipeline``) at
   Mixtral-8x7B's full widths, 2 of 32 layers: 20 training steps at lr
   3e-4 (the reference script's 100 at 2e-3, cut: 2e-3 diverges at these
   widths), then the LRU trace, the four policies,
   speculative prefetch and the overlap deployment on the reference's 3
   prompts (24 new tokens, 4 slots a layer) on masters pinned once, with
   every engine's tokens equal, spec P == R, H2D bytes exact and
   ``moe_ffn`` launched once a layer a step; a ``pipeline`` JSON line of
   the card's decode step times beside the simulated A6000 clock; then
   ``quickstart`` and ``serve_batch`` at their own sizes (LRU tokens ==
   LFU tokens; continuous batching == solo);
8. each prefill's launch counts are reset before it and read after it:
   flash attention must launch once per attention layer and once per
   cross-attention layer, SSD chunk once per SSM layer;
9. holds each kernel wrapper (``ops.moe_ffn``, ``ops.paged_attention``,
   ``ops.flash_attention``, ``ops.ssd_chunk``) and the two backward
   kernels against its plain PyTorch version on the card, on the
   arguments of the main path's heaviest call, and times both (CUDA
   events after a warm-up) beside the card's bound for the same work, a
   one-element op timed in the same 20-launch graph harness
   (``launch_floor_ms``: what a launch costs) and, for flash attention,
   one ``scaled_dot_product_attention`` call on the same inputs (a
   yardstick the port never calls). Paged attention is also timed at the
   split lengths ``SPLIT_SWEEP`` (``paged_split_sweep``: what chose its
   ``KEYS_PER_SPLIT``). The bound takes each kernel's operations at the
   peak of the units it runs them on: flash attention's and SSD chunk's
   (forward and backward) at the TF32 tensor-core rate (with the
   fp32-core bound and the three-pass 3xTF32 floor beside it), the
   others' at the fp32 rate. The flash
   backward is timed beside SDPA's forward + backward (``library_ms``)
   and SDPA's backward alone (``library_bwd_ms``), in the call's dtype
   (bf16 calls are bound at the bf16 tensor-core rate, with the work at
   the kernel's passes beside it, ``bound_passes_ms``: the forward's bf16
   wgmma ones, the backward's bf16 m16n8k16 ones); the SSD
   backward also at Jamba's published SSD shape, off the path;
10. holds each wrapper against its plain version on further shapes the
   main path does not give it: ragged C/d/F, C above 8 rows, several
   contraction slices, widths that take the 4-byte loads, other query
   heads per KV head (1 to 16), head dims up to 256 and a row with no
   visible key, 1 and 4 rows of 2048 and 4096 keys with positions on
   split boundaries, at 0 and at -1 (paged); ragged lengths, windows, no
   causal mask, values narrower than keys, MQA, bf16 (every tile call,
   fp32 and bf16, also against float64 and launched twice for bitwise
   equal outputs; bf16 at its own twins of the fp32 shapes: G 8 and 64,
   hd 192 / 128 and 256,
   rows that see no key, one query over 1500 and 1601 keys, 4096 causal
   keys), a 4096-key causal row, hd 36 and 37
   (a partial k-step), rows copied 4 bytes or one element at a time,
   the new families' shapes: one query over 1500 keys and 77 over 1601
   (no causal mask, no whole last key tile), 64 heads over 8 KV heads
   (flash), and one rank's cross calls on the (16, 16) mesh (Vision's
   2 x 32768 queries over 1601 patches at 2 heads, fp32 and bf16; 8 rows
   of 1 query, Vision's and Whisper's); other chunk lengths (37 to
   1024), head counts (1 to 256) and
   widths, P and N off the multiples of 8 (a partial k-step, 4-byte
   copies), a strongly decaying dA, Jamba's 256 heads at Q 128 (SSD),
   and a 4096-position chunk
   against a float64 evaluation of the same sums; the flash backward at
   every FLASH_BWD_SHAPES shape in fp32 and in bf16 (bf16: against the
   fp32 plain version on the same values at BF16_TOL), each also against
   float64 (fp32 at TOL, bf16 at BF16_F64_TOL) and launched twice for
   bitwise equal gradients; the SSD
   backward at every SSD chunk shape with seeded output gradients (the
   4096-position chunk against float64);
   Every FLASH_SHAPES entry that takes the one-query route (Sq·G <=
   ``ONE_QUERY_ROWS`` in fp32, ``ONE_QUERY_ROWS_BF16`` in bf16) is also
   held against float64 (bf16 within BF16_F64_TOL), launched twice for
   bitwise equal outputs, and cut to its last row and to its last two KV
   heads' query heads, bitwise the whole call's (``one_query_checks``);
11. paged attention's batch independence: one row gives bitwise the same
   output alone, as one of 16 rows, and with a table two blocks wider;
12. the engines' one-query cross-attention calls (Whisper's and
   Vision's, 2 rows), in fp32 and in bf16 (with a (16, 16) rank's Vision
   decode call, 8 rows of 2 heads): the route taken
   (``ops.route_counts``), held against the plain version and by
   ``one_query_checks``, and timed in CUDA graphs beside the tile kernel
   of the dtype, the plain version, SDPA in the same dtype and the byte
   bound (``one_query_cross`` and ``bf16_one_query`` on one line, the
   route's fp32 FMAs bound at the fp32-core rate);
13. the one-query route's batch and head independence
   (``one_query_independence``): at Vision's and Whisper's widths over 8
   rows, row 3 alone, as one of the 8 and in a call cut to 2 of its heads
   (a (16, 16) rank's cross call) bitwise equal;
14. the one-query route's choices timed (``one_query_sweep``, a line
   for fp32 and one for bf16): split lengths 32 to 256 at the engines'
   calls, and the route beside the tile kernel of the dtype at 1 to 64
   rows a KV head (over G and over Sq), with the row count up to which
   the route won (``sweep_cut``) beside the port's ``ONE_QUERY_ROWS`` /
   ``ONE_QUERY_ROWS_BF16``.

Any failed check raises, so the script exits non-zero. The output ends
with the card line, a ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout (no ``src/repro_torch`` beside the script), it exits non-zero
before printing any result.

    python3 chip_smoke.py --profile

does the same with ``torch.profiler`` tracing the serving loop and one
2 x 2048 prefill of each model (Whisper: 2 x 448), and prints a
``profile`` line for each: the device time by kind (expert copies host-to-device, each kernel,
matrix products, the rest), the device's busy and idle shares of the
traced wall time, and (serving, fp32 and int8, overlap off and on) the
copy rate at the bytes the run counts and ``by_stream``: each CUDA
stream's time by kind, the kernels on the copy stream (the int8
dequant), and the copy time that ran beside a kernel on another stream
against the time it ran alone; and one training step of each whole
model, Mamba2-2.7B's with the host stacks and a ``glue`` line naming the
ops behind its elementwise adds and fills. The profiler slows the host,
so that run's step times are not the ones to quote.
"""
import argparse
import bisect
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
PROMPT_LEN, NEW_TOKENS = 32, 16
SUBMIT_AT_STEP = (0, 0, 6, 12)      # one entry per request: staggered joins
INVARIANT_REQUESTS, INVARIANT_TOKENS = 2, 8
PREFILL_B, PREFILL_S, ENGINE_S, ENGINE_NEW = 2, 2048, 512, 8
MAMBA_LAYERS = 8                    # of 64: bounds the token-by-token engine
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12            # H100 SXM, fp32 outside tensor cores
TF32_FLOPS_PER_S = 495e12           # H100 SXM, TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12           # H100 SXM, bf16 tensor cores, dense
# the peak each kernel's operations run at: flash attention's and SSD
# chunk's products, forward and backward, are TF32 tensor-core MMAs (3
# passes each for fp32 inputs), the rest fp32
PEAK = {"flash_attention": ("tf32 tensor cores", TF32_FLOPS_PER_S),
        "flash_attention_bwd": ("tf32 tensor cores", TF32_FLOPS_PER_S),
        "ssd_chunk": ("tf32 tensor cores", TF32_FLOPS_PER_S),
        "ssd_chunk_bwd": ("tf32 tensor cores", TF32_FLOPS_PER_S)}
FP32_PEAK = ("fp32 cores", FP32_FLOPS_PER_S)
# a call on bf16 inputs: the least time for its work is at the bf16 rate
BF16_PEAK = ("bf16 tensor cores", BF16_FLOPS_PER_S)
# kernel vs plain, fp32: rtol = atol (summation order), except ssd_chunk,
# whose sums over a 256-position chunk reach |y| ~ 200, and the two
# backwards, whose gradients sum over up to 2048 keys or queries and G
# heads (flash) or over a chunk's pairs and all its heads (SSD): there the
# bound is max |kernel - plain| <= TOL * max |plain|
TOL = {"moe_ffn": 1e-4, "paged_attention": 2e-4, "flash_attention": 2e-4,
       "ssd_chunk": 2e-5, "flash_attention_bwd": 2e-5, "ssd_chunk_bwd": 2e-5}
# kernels held at max |kernel - plain| <= TOL x max |plain| (each output)
MAX_RELATIVE = ("ssd_chunk", "flash_attention_bwd", "ssd_chunk_bwd")
BF16_TOL = 2e-2     # bf16 output rounding (2^-8 relative) of values up to ~4
# the bf16 flash backward against float64: max |kernel - float64| <= this
# x max |float64|, each of dq, dk, dv: one rounding to bf16 at the store
# (at most half an ulp, 2^-8 of a value) over the fp32 kernel's 2e-5
BF16_F64_TOL = 2.0 ** -8
# prefill vs the decode_step loop, fp32 logits: rtol = atol (flash vs
# dense-cache attention, chunked SSD vs the recurrence: summation order)
PREFILL_TOL = 3e-3
# the same in a bf16 model (the encdec / vlm engines in their configs'
# dtype), as max |prefill - decode| <= this x max |prefill|: hidden
# states kept in bf16 and rounded at other places by the prefill's
# kernels and the decode loop's (tile kernel vs one-query route, GEMMs vs
# GEMVs), a few bf16 roundings (2^-8 of the largest value each) by the
# last layer. Measured on an H100: 9.8e-3 at a max of 1.67 (5.8e-3 x
# max, Whisper-tiny), 7.0e-2 at 5.91 (1.2e-2 x max, Llama-3.2-Vision);
# up to 1.7e-2 x max between the port's and JAX's bf16 paths on the CPU
# (tests/test_torch_bf16_serving.py, the same bound)
BF16_PREFILL_TOL = 2.0 ** -5
# further shapes for step 10: (E, C, d, F), the CPU tests' moe_ffn shapes
# then C > 8 rows over several ragged contraction slices (4- and 16-byte
# loads); (B, H, KV, hd, N, bs, T), the CPU tests' paged shapes then 3, 5,
# 12 and 16 query heads per KV head and head dims 40, 72, 256
MOE_SHAPES = [(2, 32, 128, 256), (4, 96, 128, 384), (3, 40, 256, 512),
              (1, 8, 128, 128), (2, 12, 130, 96), (1, 5, 64, 500),
              (2, 7, 100, 130), (4, 3, 200, 640), (3, 9, 2500, 1100),
              (2, 17, 1030, 2050)]
PAGED_SHAPES = [(2, 4, 2, 64, 8, 8, 3), (3, 4, 4, 64, 10, 16, 2),
                (1, 8, 1, 128, 6, 8, 4), (2, 6, 2, 40, 20, 8, 9),
                (3, 15, 3, 72, 9, 4, 6), (2, 12, 1, 128, 12, 16, 4),
                (2, 16, 1, 256, 12, 16, 5)]
# paged rows of 2048 and 4096 keys at Mixtral widths (H 32, KV 8, hd 128,
# 16-key blocks), 1 and 4 rows: (keys, positions) with S = the kernel's
# split length: full rows, pos on a split boundary (S - 1: the last key of
# split 0; S and 2S: the first key of a new split), 0 and -1
PAGED_LONG = [(2048, ["S"]), (2048, [2047, "S-1", "S", 0]), (4096, [-1]),
              (4096, [4095, "2S", 0, -1])]
SPLIT_SWEEP = (32, 64, 128, 256)    # split lengths timed beside the kernel's
# (B, Sq, Sk, H, KV, hd, vd, causal, window, dtype) for flash attention:
# ragged S (1, 37, 160, 333, 1000), windows 37 and 1024, no causal mask,
# MLA widths (hd 192, vd 128), MQA and 1 to 16 query heads per KV head,
# hd 36 to 256, bf16, more queries than keys under a window (rows that
# see no key), a 4096-key causal row (drift over 128 tiles), hd 36 and 37
# (a partial k8 step), rows of 4-byte copies (fp32 hd 37, vd 21) and of
# element loads (bf16 hd 37, vd 21); (G, Q, H, P, N, dA scale) for SSD
# chunk: Q 64 and 100, H 6, P 32, N 16 and 64, G 1, a chunk ragged in
# every width, then a 1024-position chunk (drift over 32 key tiles), N 20
# and P 37 (a partial k8 step; 4-byte xw copies), P 21 and N 37 (4-byte
# copies of every input), H 1, and dA ~ -|N(0, 1)| (the decay underflows
# to 0 across the chunk). SSD_ORACLE_SHAPE: a 4096-position chunk, where
# the plain version's own fp32 cumsum is off the exact sums by more than
# the tolerance, so the kernel is held against float64 there. Then the
# shapes of the hybrid, encdec and vlm phases: a decode step's Whisper
# cross-attention (1 query over 1500 frames, MHA at hd 64), Llama-3.2-
# Vision's cross-attention (Sq != Sk, 1601 keys: no whole last tile),
# Jamba's self-attention (8 query heads a KV head, 64 heads) and its SSD
# chunk (Q 128, 256 heads); then one rank's SSD call of prefill_32k on
# the (16, 16) mesh, where each rank runs 2 rows and H / 16 heads: Mamba2's
# (G 2 x 128 chunks, Q 256, H 80 / 16 = 5) and Jamba's (G 2 x 256, Q 128,
# H 256 / 16 = 16); and one rank's cross-attention calls on that mesh:
# Llama-3.2-Vision's at prefill_32k (2 rows of 32768 queries over 1601
# patches, 32 / 16 = 2 heads; fp32 and bf16) and at decode_32k (8 rows, 1
# query), and Whisper-tiny's at decode_32k (8 rows, 1 query over 1500
# frames, all 6 heads: its weights are whole). World size 1 never
# launches these. Then bf16 twins of fp32 shapes above, for the bf16
# forward's own kernel: 64 heads over 8 KV heads at 2048 positions, and 64
# query heads a KV head (G 64, the most a block takes); MLA's hd 192 / vd
# 128 and hd 256 (its widest instantiations); more queries than keys under
# a window (rows that see no key); one query over 1500 and over 1601 keys
# (one position a block, keys in ragged 128-key tiles); the 4096-key
# causal row (drift over 32 tiles). Last, widths past MLA's with a narrow
# v, which take the widest instantiation: hd 256 / vd 128 (fp32 too) and a
# partial last panel, hd 200 / vd 120; and 64 query heads a KV head over
# 131100 positions, more position tiles (two positions a block) than a
# grid's y dimension takes (65535). Then the one-query route's masked
# shapes of tests/test_torch_flash_one_query.py (fp32 at Sq·G <=
# ONE_QUERY_ROWS = 8 rows a KV head): causal, window 37 and both at Sq 4
# with G 2 (8 rows), Sq 3 over Sk 2 under window 1 (a row that sees no
# key: uniform), G 8 at one query, and hd 37 / vd 21 (4-byte copies) over
# 129 keys in G 2; and G 16 at one query, past the cut (the tile kernel).
# Then the bf16 route's own: hd 37 / vd 21 (element loads: a bf16 row of
# 74 bytes) over 600 keys in 3 splits, and one causal query over 300 keys
# (one split walked of three).
FLASH_SHAPES = [(1, 1, 1, 4, 2, 64, 64, True, 0, "float32"),
                (1, 37, 37, 8, 8, 64, 64, True, 0, "float32"),
                (2, 160, 160, 4, 2, 64, 64, True, 37, "float32"),
                (2, 1000, 1000, 12, 1, 72, 72, True, 1024, "float32"),
                (1, 96, 96, 4, 1, 128, 128, False, 0, "float32"),
                (1, 129, 129, 3, 3, 40, 40, False, 37, "float32"),
                (1, 300, 300, 6, 2, 192, 128, True, 0, "float32"),
                (1, 200, 200, 16, 1, 256, 256, True, 37, "float32"),
                (1, 100, 40, 4, 2, 64, 64, True, 16, "float32"),
                (2, 256, 256, 32, 8, 128, 128, True, 0, "bfloat16"),
                (1, 160, 160, 4, 2, 64, 64, False, 37, "bfloat16"),
                (1, 4096, 4096, 32, 8, 128, 128, True, 0, "float32"),
                (2, 333, 333, 32, 4, 36, 36, True, 0, "float32"),
                (1, 70, 70, 6, 3, 37, 21, True, 0, "float32"),
                (1, 70, 70, 6, 3, 37, 21, True, 0, "bfloat16"),
                (2, 1, 1500, 6, 6, 64, 64, False, 0, "float32"),
                (1, 77, 1601, 32, 32, 128, 128, False, 0, "float32"),
                (1, 2048, 2048, 64, 8, 128, 128, True, 0, "float32"),
                (2, 32768, 1601, 2, 2, 128, 128, False, 0, "float32"),
                (2, 32768, 1601, 2, 2, 128, 128, False, 0, "bfloat16"),
                (8, 1, 1601, 2, 2, 128, 128, False, 0, "float32"),
                (8, 1, 1500, 6, 6, 64, 64, False, 0, "float32"),
                (1, 2048, 2048, 64, 8, 128, 128, True, 0, "bfloat16"),
                (1, 96, 96, 64, 1, 64, 64, True, 0, "bfloat16"),
                (1, 300, 300, 6, 2, 192, 128, True, 0, "bfloat16"),
                (1, 200, 200, 16, 1, 256, 256, True, 37, "bfloat16"),
                (1, 100, 40, 4, 2, 64, 64, True, 16, "bfloat16"),
                (2, 1, 1500, 6, 6, 64, 64, False, 0, "bfloat16"),
                (8, 1, 1601, 2, 2, 128, 128, False, 0, "bfloat16"),
                (1, 4096, 4096, 32, 8, 128, 128, True, 0, "bfloat16"),
                (1, 200, 200, 16, 1, 256, 128, True, 0, "float32"),
                (1, 200, 200, 16, 1, 256, 128, True, 0, "bfloat16"),
                (1, 150, 150, 8, 2, 200, 120, True, 0, "bfloat16"),
                (1, 131100, 40, 64, 1, 16, 16, False, 0, "bfloat16"),
                (2, 4, 100, 8, 4, 64, 64, True, 0, "float32"),
                (2, 4, 100, 8, 4, 64, 64, False, 37, "float32"),
                (2, 4, 100, 8, 4, 64, 64, True, 37, "float32"),
                (2, 3, 2, 4, 2, 64, 64, False, 1, "float32"),
                (2, 3, 2, 4, 2, 64, 64, True, 1, "float32"),
                (1, 1, 100, 8, 1, 64, 64, False, 0, "float32"),
                (2, 1, 129, 6, 3, 37, 21, False, 0, "float32"),
                (1, 1, 100, 16, 1, 64, 64, False, 0, "float32"),
                (2, 1, 600, 6, 6, 37, 21, False, 0, "bfloat16"),
                (2, 1, 300, 4, 4, 64, 64, True, 0, "bfloat16")]
# the one-query cross-attention calls the engines launch at every decode
# step, timed alone (B, Sk, H, hd): Whisper-tiny's 2 rows over 1500
# frames, 6 heads of 64, and Llama-3.2-Vision's over 1601 patches, 32
# heads of 128
ONE_QUERY_CROSS = [(2, 1500, 6, 64), (2, 1601, 32, 128)]
# their bf16 twins (the configs' own dtype), held and timed the same way,
# and a (16, 16) rank's Vision decode call in bf16 (8 rows, 2 heads)
ONE_QUERY_CROSS_BF16 = ONE_QUERY_CROSS + [(8, 1601, 2, 128)]
# the families whose phase runs again in their configs' own bf16 after
# the fp32 one (``family_phase``)
BF16_ENGINES = ("whisper-tiny", "llama-3.2-vision-11b")
# the one-query route's two choices, timed beside each other
# (``one_query_sweep``): its split lengths at those calls, and the rows a
# KV head (Sq·G) at which it and the tile kernel are timed, over G at one
# query and over Sq at G 1 (1601 keys, KV heads of 128), at B x KV = 2 x 8
# (16 blocks of the tile kernel: a fraction of the card) and 8 x 32 (256:
# most of a wave of it)
ONE_QUERY_SPLIT_SWEEP = (32, 64, 128, 256)
ONE_QUERY_ROW_SWEEP = (1, 2, 4, 8, 16, 32, 64)
ONE_QUERY_ROW_CALLS = (("G", 2, 8), ("Sq", 2, 8), ("G", 8, 32),
                       ("Sq", 8, 32))
SSD_SHAPES = [(1, 64, 6, 32, 16, 0.1), (2, 100, 6, 32, 64, 0.1),
              (1, 64, 6, 32, 64, 0.1), (3, 37, 5, 72, 130, 0.1),
              (2, 256, 80, 64, 128, 0.1), (2, 1024, 8, 64, 128, 0.1),
              (2, 100, 3, 37, 20, 0.1), (1, 70, 2, 21, 37, 0.1),
              (2, 256, 1, 64, 128, 0.1), (2, 256, 8, 64, 128, 1.0),
              (32, 128, 256, 64, 128, 0.1), (256, 256, 5, 64, 128, 0.1),
              (512, 128, 16, 64, 128, 0.1)]
SSD_ORACLE_SHAPE = (1, 4096, 2, 64, 128, 0.1)
# Jamba-1.5-Large's published SSD call (G, Q, H, P, N): 2 x 2048 tokens in
# chunks of 128, 256 heads of 64, state 128; the SSD backward is timed
# there off the path (the hybrid trains on the card only reduced, below)
JAMBA_SSD_SHAPE = (32, 128, 256, 64, 128)
# (B, Sq, Sk, H, KV, hd, vd, causal, window) for the flash attention
# backward beside the training path's calls: a window, a ragged S, one
# query over Whisper's 1500 frames and its 448-token decoder over them,
# the VLM's 77 queries over 1601 patches (Sq != Sk, no causal mask), MLA
# widths (hd 192, vd 128), rows that see no key (Sq > Sk + window), MQA
# at hd 256, widths off the multiples of 8, 64 query heads a KV head, a
# wide q/k with a narrow v (hd 160, vd 24), and 3 query heads a KV head
# at aligned widths (the bf16 keys launch's row tiles then leave rows no
# TMA box fills, and its stats boxes start off 16-byte boundaries)
FLASH_BWD_SHAPES = [(2, 160, 160, 4, 2, 64, 64, True, 37),
                    (1, 333, 333, 8, 2, 64, 64, True, 0),
                    (2, 1, 1500, 6, 6, 64, 64, False, 0),
                    (2, 448, 1500, 6, 6, 64, 64, False, 0),
                    (1, 77, 1601, 32, 32, 128, 128, False, 0),
                    (1, 300, 300, 16, 16, 192, 128, True, 0),
                    (1, 100, 40, 4, 2, 64, 64, True, 16),
                    (1, 200, 200, 16, 1, 256, 256, True, 37),
                    (1, 70, 70, 6, 3, 37, 21, True, 0),
                    (1, 40, 40, 64, 1, 32, 32, False, 0),
                    (1, 150, 150, 8, 2, 160, 24, True, 0),
                    (2, 96, 96, 6, 2, 64, 64, True, 0)]
# the training phase: (arch, layers (None: all), batch, sequence, steps,
# AdamW learning rate, dtype) at published widths, remat, under train()'s
# cosine schedule (warm-up of one step: step 0 moves nothing). lm_batches'
# language is a random bigram table over the whole vocabulary, so a few
# steps can only shrink the initial logits' excess over the uniform
# loss; at 1e-3 Mixtral's loss on batches of 2048 tokens rose on step 2
# and ended above its first, at 1e-4 it falls
#
# Qwen2.5-3B whole in its published bf16 (hf:Qwen/Qwen2.5-3B: 36 layers, d
# 2048, 16 query heads over 2 KV heads of 128, d_ff 11008, vocab 151936,
# tied embeddings, QKV bias; 3.09 B params): 6.2 GB of bf16 params, 6.2
# GB of bf16 grads and 24.7 GB of fp32 AdamW moments. The others train in
# fp32.
#
# Mamba2-2.7B whole: 64 layers, 2.7 B params, ~43 GB of fp32 params, grads
# and AdamW moments. The hybrid cannot train at Jamba's published widths
# on one card: layer i is MoE iff i % 2 == 1 and attention iff i %
# attn_every == 0 (attn_every even), so any cut that holds an SSM layer
# also holds a 16-expert SSM + MoE layer, 16 x 3 x 8192 x 24576 = 9.66 B
# params, 155 GB at 16 bytes a param in fp32 with AdamW: twice the card.
# So it trains reduced (a dict: ``reduced()``'s arguments; attention every
# second layer, chunks of 64), and its SSD backward is timed at the
# published shape (JAMBA_SSD_SHAPE) as a kernel call.
TRAIN_RUNS = (("qwen1.5-0.5b", None, 4, 2048, 10, 1e-3, "float32"),
              ("qwen2.5-3b", None, 2, 2048, 6, 3e-4, "bfloat16"),
              ("mixtral-8x7b", 2, 1, 2048, 8, 1e-4, "float32"),
              ("mamba2-2.7b", None, 2, 2048, 8, 1e-4, "float32"),
              ("jamba-1.5-large-398b", {"layers": 4, "d_model": 512}, 2,
               512, 8, 1e-3, "float32"))
# the run that first takes one step through the kernels against the same
# step through the plain versions, in each of STEP_TOL's dtypes: both
# routes' params and grads stay live, which Qwen1.5-0.5B's 0.46 B params
# allow and Mamba2's 2.7 B or Qwen2.5-3B's 3.09 B (with AdamW) not
STEP_COMPARE_ARCH = "qwen1.5-0.5b"
# the run whose profiled step (``--profile``) also records the host stacks
# and names the ops behind its elementwise adds and fills (``glue_sources``)
GLUE_ARCH = "mamba2-2.7b"
# one Qwen step through the kernels against the same step through the
# plain version, by dtype: (loss and grad-norm differences, relative;
# every gradient's difference over the largest |gradient|; the post-AdamW
# params' share of |p| beside what the two gradients explain: AdamW's
# first step is g / (|g| + eps), so its change is at most 2 |dg| / |g| of
# lr, and at most 2 lr where a near-zero gradient's sign differs). fp32:
# summation order, 1e-4, 1e-4, 1e-6. bf16: both routes compute the
# attention in fp32 and round its output and dq, dk, dv to bf16 once, so
# they differ where the two fp32 values round to neighbouring bf16 values
# (one ulp, at most 2^-7 of a value), and every bf16 op after it rounds
# again, so a flip moves later roundings too: loss and norm within 2^-8
# (half an ulp), each gradient within 2^-5 x the largest (four ulps of
# the largest: through Qwen1.5-0.5B's 24 layers the differences reach a
# few ulps everywhere; 1.84% of the largest read on an H100), the params
# within one bf16 ulp of |p| (2^-7) beside what the gradients explain
STEP_TOL = {"float32": (1e-4, 1e-4, 1e-6),
            "bfloat16": (2.0 ** -8, 2.0 ** -5, 2.0 ** -7)}
# the DeepSeek-V2 phase: depth cut to 2 of 60 layers at the published
# widths, 32 expert slots a layer (20% of its 160 routed experts)
DS_LAYERS, DS_SLOTS = 2, 32
# the dry-run phase (6d): DRY_B rows of DRY_S tokens through prefill, one
# decode_step of DRY_B rows at position DRY_S in a cache of DRY_CACHE
# slots; then the dry run's CLI on DRY_CASES of the (16, 16) mesh
DRY_B, DRY_S, DRY_CACHE = 2, 2048, 4096
DRY_CASES = (("qwen1.5-0.5b", "decode_32k"),
             ("deepseek-v2-236b", "prefill_32k"))
# the distributed phase at world size 1: one MoE layer of Mixtral-8x7B on
# EP_B x EP_S tokens (4096: what ``moe_apply`` needs to take EP); the MLA
# decode of DeepSeek-V2 (DS_LAYERS), MLA_B rows over MLA_STEPS greedy
# steps in a cache of MLA_CACHE slots, its logits within MLA_TOL x max
EP_B, EP_S = 2, 2048
MLA_B, MLA_STEPS, MLA_CACHE, MLA_TOL = 2, 8, 16, 1e-5
# the head-split SSM decode of Mamba2-2.7B (MAMBA_LAYERS): SSM_B rows over
# SSM_STEPS greedy steps, its logits within SSM_TOL x max of the unsharded
# decode where they are not bitwise equal
SSM_B, SSM_STEPS, SSM_TOL = 2, 8, 1e-6
# the encdec / vlm mesh checks: CROSS_STEPS greedy steps of CROSS_B rows,
# logits within CROSS_TOL x max of the unsharded decode
CROSS_B, CROSS_STEPS, CROSS_TOL = 2, 8, 1e-6
# a prefill under the mesh against the plain one, timed again in turns
TURNS = ("plain", "mesh", "mesh", "plain")
# the phases of the other families, at published widths, cut in depth:
# Jamba-1.5-Large 2 of 72 layers in periods of 2 (one attention layer with
# a dense SwiGLU, one SSM layer with the 16-expert MoE), Whisper-tiny whole
# (4 + 4 layers) on its 448-token text context, Llama-3.2-Vision-11B one
# period (4 plain layers and 1 cross layer) of 40 layers
JAMBA_LAYERS, WHISPER_S, VLM_LAYERS = 2, 448, 5
# the train steps under the (1, 1) mesh (6a, g): (arch, layers or None for
# the whole model, rows, positions, lr, the moe path of the mesh step), in
# fp32; Mixtral's mesh step takes the expert-parallel path, its plain one
# ``auto`` (``moe_capacity``); Whisper's batch holds its 1500 frames
MESH_TRAIN_RUNS = (("qwen1.5-0.5b", None, 2, 2048, 1e-3, "auto"),
                   ("mixtral-8x7b", 2, 1, 2048, 1e-4, "ep"),
                   ("mamba2-2.7b", MAMBA_LAYERS, 1, 2048, 1e-4, "auto"),
                   ("whisper-tiny", None, 2, WHISPER_S, 1e-3, "auto"))
MESH_TRAIN_STEPS = 2
# ZeRO-1 under the (1, 1) mesh (6a, h): (arch, layers, rows, positions,
# lr, the moe path of the mesh step, dtype) of the two ``zero1`` configs
# at their published widths, cut
# to one layer. Jamba-1.5-Large stacks its layers by period (attention
# every 8th), so its one-layer cut holds 1 // 8 = 0 periods: every layer
# stack is empty (0 long) and the step runs the embedding, the final norm
# and the unembedding's cross entropy over 65536 words, 1.07 B params,
# 17.2 GB of fp32 params, gradients and moments. DeepSeek-V2's layer is
# MLA beside 160 routed and 2 shared experts, 5.10 B params, in its
# published bf16: 20.4 GB of params and gradients, 40.8 GB of fp32
# moments. On 2048 tokens ``auto`` takes ``moe_capacity`` (EP needs 4096)
ZERO1_TRAIN_RUNS = (("jamba-1.5-large-398b", 1, 1, 2048, 1e-3, "auto",
                     "float32"),
                    ("deepseek-v2-236b", 1, 1, 2048, 1e-4, "capacity",
                     "bfloat16"))
# the memory-tier phase: slots a layer and KV blocks the budget is built
# for, the block length, and the workload (requests, prompt and new tokens)
TIER_SLOTS, TIER_BLOCKS, TIER_BLOCK_SIZE = 4, 4, 16
TIER_REQUESTS, TIER_PROMPT_LEN, TIER_TOKENS = 3, 24, 16
# trace fields that are the run's decisions (the float64 gate sums differ
# in their last bits between runs of other kernels, so they are left out)
FUNCTIONAL = ("activated", "hits", "misses", "evicted", "spec_guess",
              "prefetched")
# stats() keys of the simulated clock, which overlap=True changes by
# design; every other key must be equal between overlap off and on
CLOCK_KEYS = ("transfer_busy_s", "exposed_transfer_s",
              "exposed_transfer_frac", "dma_preempted", "sim_time_s",
              "sim_tokens_per_s", "p99_step_s")
# with tiers, the stall sum follows the clock too (its last bits differ)
TIER_CLOCK_KEYS = CLOCK_KEYS + ("tier_stall_s",)
# torch.cuda._sleep cycles queued before every install (copy stream) or
# every moe_ffn (compute stream) in the race checks: ~10 ms at ~2 GHz,
# most of one fp32 expert copy
SLEEP_CYCLES = 20_000_000
# the race checks' cache: 2 slots a layer, so a 2-row batch union of up to
# 4 experts streams in 2 chunks and chunk 2's installs evict chunk 1's
# experts, whose moe_ffn may still be queued (the last-reader event's case)
RACE_SLOTS = 2
# the launch phase (7c): the train CLI on Qwen1.5-0.5B whole (the published
# config, bf16), the serve CLI at its own reduced sizes (its prompt is 8
# tokens), the paper's
# pipeline at Mixtral-8x7B's full widths cut to 2 of 32 layers, its
# training cut from the reference script's 100 steps to 20 and its
# learning rate from 2e-3 to 3e-4: at d_model 4096 the loss rose at 2e-3
# (100 steps: 11.23 -> peaks near 16.6 -> 11.81) and 1e-3 (-> 11.63), and
# fell at 3e-4 (-> 11.12) and 1e-4 (-> 11.19) (tools/pipeline_lr_sweep.py)
LAUNCH_TRAIN = ["--arch", "qwen1.5-0.5b", "--steps", "3", "--batch", "4",
                "--seq", "2048"]
LAUNCH_SERVE = ["--arch", "mixtral-8x7b", "--policy", "lfu", "--prefetch",
                "spec", "--cache-slots", "4", "--tokens", "16", "--layers",
                "2", "--d-model", "256"]
SERVE_RUNS = (("lfu_spec", LAUNCH_SERVE),
              ("lfu_spec_overlap", LAUNCH_SERVE + ["--overlap"]),
              ("lfu_spec_int8", LAUNCH_SERVE + ["--quant", "int8"]),
              ("device", ["--mode", "device", "--arch", "qwen2.5-3b"]))
SERVE_PROMPT_LEN = 8
PIPELINE_LAYERS, PIPELINE_STEPS, PIPELINE_LR = 2, 20, 3e-4
SOURCES = {  # kernel -> (CUDA source, the TPU kernel it replaces)
    "moe_ffn": ("src/repro_torch/kernels/csrc/moe_gemm.cu",
                "src/repro/kernels/moe_gemm.py:40"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:70"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:55"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "no TPU counterpart: the JAX package trains through XLA blockwise "
        "(src/repro/models/attention.py:146)"),
    "ssd_chunk_bwd": (
        "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "no TPU counterpart: the JAX package trains through the XLA SSD "
        "step (src/repro/models/ssm.py:22)"),
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, iters: int, *, graph: bool) -> float:
    """Milliseconds per call of ``fn`` on the device, by CUDA events
    after a warm-up. ``graph=True`` captures the ``iters`` calls in a
    CUDA graph first, so a kernel shorter than its host-side launch is
    timed on the device, not on the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_keys(q, kp, vp, bt, pos):
    """Keys a paged_attention call reads: pos + 1 for each row."""
    return int((pos.long() + 1).clamp(max=bt.shape[1] * kp.shape[1]).sum())


@contextlib.contextmanager
def recording(ops, seen, specs):
    """Wrap the kernel wrappers ``ops.<name>`` named in ``specs`` (name ->
    (size, keep)) so that each call whose ``size(*args, **kw)`` is the
    largest so far leaves ``keep(*args, **kw)`` in ``seen[name]``."""
    originals = {name: getattr(ops, name) for name in specs}

    def wrap(name, wrapper, size, keep):
        def call(*args, **kw):
            n = size(*args, **kw)
            if name not in seen or n >= seen[name][0]:
                seen[name] = (n, keep(*args, **kw))
            return wrapper(*args, **kw)
        return call

    for name, (size, keep) in specs.items():
        setattr(ops, name, wrap(name, originals[name], size, keep))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def patched(owner, name, make):
    """Replace ``owner.<name>`` by ``make(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def reusing(store):
    """Servers built inside the block take ``store`` (expert masters
    already pinned, or already quantized) instead of building their own
    from the params."""
    from repro_torch.core.expert_store import ExpertStore

    def make(_):
        def from_params(params, cfg, *, quant="none", pin=False):
            check(quant == store.quant and pin == store.pin,
                  f"reused store is quant={store.quant} pin={store.pin}, "
                  f"the server asked for quant={quant} pin={pin}")
            return store
        return from_params
    return patched(ExpertStore, "from_params", make)


def install_streams(streams):
    """Record, for every expert install inside the block, (the cache's
    copy stream, the stream the install's copies were queued on)."""
    import torch
    from repro_torch.core.expert_cache import ExpertCache

    def make(copy_in):
        def call(self, *args, **kw):
            streams.append((self.copy_stream, torch.cuda.current_stream()))
            return copy_in(self, *args, **kw)
        return call
    return patched(ExpertCache, "_copy_in", make)


# the serving kernels' calls ``recording`` keeps: the heaviest (moe_ffn:
# most expert rows E*C; paged_attention: most visible keys), its small
# arguments copied as they were
SERVING_SPECS = {
    "moe_ffn": (lambda x_e, *_: x_e.shape[0] * x_e.shape[1],
                # the slot buffers (GBs) are kept by reference
                lambda x_e, w1, w3, w2, slots: (x_e.clone(), w1, w3, w2,
                                                list(slots))),
    "paged_attention": (visible_keys,
                        lambda *args: tuple(a.clone() for a in args)),
}


def timed_moves(moves):
    """Record every ``PagedKVCache._move`` inside the block (a park's copy
    to host or a resume's to the card) into ``moves`` as ("park" or
    "resume", the stream it was queued on, its host bytes, whether the
    host buffer is pinned, start and end CUDA events)."""
    import torch
    from repro_torch.core.paged_kv import PagedKVCache

    def recorded(move):
        def call(self, dst, src):
            host = src if dst.is_cuda else dst
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            move(self, dst, src)
            end.record()
            moves.append(("resume" if dst.is_cuda else "park",
                          torch.cuda.current_stream(), host.nbytes,
                          host.is_pinned(), start, end))
        return call
    return patched(PagedKVCache, "_move", recorded)


def move_times(moves):
    """Parks' and resumes' counts, host bytes, copy ms and GB/s (after a
    synchronization) from ``timed_moves``' records."""
    out = {}
    for kind in ("park", "resume"):
        ms = [a.elapsed_time(b) for k, _, _, _, a, b in moves if k == kind]
        nb = [n for k, _, n, _, _, _ in moves if k == kind]
        out[kind] = {"n": len(ms), "bytes": nb, "ms": ms,
                     "gb_per_s": [n / m / 1e6 for n, m in zip(nb, ms)]}
    return out


def tier_plan(cfg, quant):
    """Phase 4d's tiered server: (its kwargs: one ``hbm_budget_bytes``
    whose plan lands on TIER_SLOTS slots a layer and TIER_BLOCKS blocks of
    TIER_BLOCK_SIZE, max_batch 2, 4-token prefill chunks, LFU,
    speculative prefetch; the plan's slot and block prices), and its
    TIER_REQUESTS seeded prompts."""
    import numpy as np
    from repro_torch.core.costmodel import ModelBytes
    from repro_torch.serving.offload_serving import _planned_expert_bytes
    slot_price = _planned_expert_bytes(cfg)
    block_price = (TIER_BLOCK_SIZE * ModelBytes.from_config(cfg)
                   .kv_bytes_per_token * cfg.num_layers)
    experts_part = TIER_SLOTS * cfg.num_layers * slot_price
    budget = experts_part + TIER_BLOCKS * block_price
    base = dict(max_batch=2, prefill_chunk=4, kv_block_size=TIER_BLOCK_SIZE,
                policy="lfu", prefetch="spec", hbm_budget_bytes=budget,
                tier_expert_frac=experts_part / budget + 1e-9,
                quant=quant, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             TIER_PROMPT_LEN)]
               for _ in range(TIER_REQUESTS)]
    return base, {"slot": slot_price, "block": block_price}, prompts


def serve(srv, prompts, ops, prof=None, per_step=None):
    """Run the staggered workload; record each kernel wrapper's heaviest
    call (moe_ffn: most expert rows E*C; paged_attention: most visible
    keys), its small arguments copied as they were. Each step's
    host-to-device expert bytes must equal (misses + prefetches) of the
    trace rows it added times the bytes of one stored expert. Every
    install must run on the engine's copy stream when it has one
    (``overlap=True``), else on the compute stream. A list ``per_step``
    gets, after each step, (the launch counts so far, the trace rows the
    step added: one a layer). Returns (rids, launches, per-step ms,
    per-step H2D bytes, recorded calls, loop ms)."""
    import torch
    seen, streams = {}, []
    compute = torch.cuda.current_stream()
    rids, step_ms, step_h2d = [], [], []
    expert_bytes = srv.engine.store.expert_nbytes((0, 0))
    with recording(ops, seen, SERVING_SPECS), install_streams(streams):
        ops.reset_launch_counts()
        if prof is not None:
            prof.start()
        torch.cuda.synchronize()
        t_loop = time.perf_counter()
        step = 0
        while len(rids) < len(prompts) or srv.pending:
            for i, at in enumerate(SUBMIT_AT_STEP):
                if at == step and len(rids) == i:
                    rids.append(srv.submit(prompts[i], max_new=NEW_TOKENS))
            h2d = sum(c.bytes_transferred for c in srv.engine.caches)
            rows = len(srv.trace.steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_h2d.append(sum(c.bytes_transferred
                                for c in srv.engine.caches) - h2d)
            moved = sum(len(r.misses) + len(r.prefetched)
                        for r in srv.trace.steps[rows:])
            if per_step is not None:
                per_step.append((ops.launch_counts(),
                                 len(srv.trace.steps) - rows))
            check(step_h2d[-1] == moved * expert_bytes,
                  f"step {step}: {step_h2d[-1]} H2D bytes, the trace moved "
                  f"{moved} experts of {expert_bytes} bytes")
            step += 1
        loop_ms = (time.perf_counter() - t_loop) * 1e3
        if prof is not None:
            prof.stop()
        launches = ops.launch_counts()
    copy = srv.engine.copy_stream
    check((copy is not None) == srv.engine.overlap,
          f"overlap={srv.engine.overlap} but copy stream {copy}")
    check(bool(streams), "no expert install in the serving run")
    # (`None != stream` is False in PyTorch: test `is None` first)
    where = copy if copy is not None else compute
    check((copy is None or copy != compute)
          and all(c == copy and s == where for c, s in streams),
          f"installs ran on {sorted({str(s) for _, s in streams})}, "
          f"expected {where} (compute stream {compute})")
    return (rids, launches, step_ms, step_h2d,
            {k: v[1] for k, v in seen.items()}, loop_ms)


KINDS = (  # profiler kernel-name fragments -> kind, first match wins
    (("skinny_partial", "swiglu_finish", "sum_partials"), "moe_ffn"),
    (("paged_attention_kernel",), "paged_attention"),
    (("flash_fwd_f32", "flash_fwd_bf16"), "flash_attention"),
    (("flash_bwd_",), "flash_attention_bwd"),
    (("ssd_chunk_scores_kernel", "ssd_chunk_kernel"), "ssd_chunk"),
    (("ssd_bwd_",), "ssd_chunk_bwd"),
    # cuBLAS's bf16 products on Hopper are "nvjet_*" kernels
    (("gemm", "xmma", "cutlass", "cublas", "nvjet"), "matmul"),
)


def kind_of(name):
    """A profiler device event's kind, from its name."""
    if name.startswith("Memcpy HtoD"):
        return "h2d_copy"
    if name.startswith(("Memcpy", "Memset")):
        return "other_copy"
    return next((k for frags, k in KINDS if any(f in name for f in frags)),
                "other_kernels")


def merged(spans):
    """Sorted, non-overlapping union of (start, end) spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(union, starts, a, b):
    """Length of [a, b) that the merged spans ``union`` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(union) and union[i][0] < b:
        total += max(0, min(union[i][1], b) - max(union[i][0], a))
        i += 1
    return total


def stream_split(prof):
    """The traced window's device activity by CUDA stream (the profiler's
    device resource id): each stream's ms by kind; the host-to-device
    copy time that ran while a kernel ran on another stream (the measured
    overlap) and the copy time that ran alone; the kernels that ran on
    the streams that carried most of the copies and no moe_ffn (the copy
    stream: the int8 dequant multiply lands there)."""
    from torch.autograd import DeviceType
    by_stream = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_stream.setdefault(ev.device_resource_id, []).append(
                (ev.time_range.start, ev.time_range.end, kind_of(ev.name),
                 ev.name))
    kernels = {s: [(a, b) for a, b, k, _ in v
                   if k not in ("h2d_copy", "other_copy")]
               for s, v in by_stream.items()}
    h2d_total = sum(b - a for v in by_stream.values()
                    for a, b, k, _ in v if k == "h2d_copy")
    streams, overlap_us, alone_us = {}, 0.0, 0.0
    for s, v in by_stream.items():
        union = merged([iv for t, ivs in kernels.items() if t != s
                        for iv in ivs])
        starts = [a for a, _ in union]
        rec = {"ms_by_kind": {}, "h2d_count": 0}
        for a, b, k, _ in v:
            rec["ms_by_kind"][k] = rec["ms_by_kind"].get(k, 0.0) + (b - a) / 1e3
            if k == "h2d_copy":
                rec["h2d_count"] += 1
                o = covered(union, starts, a, b)
                overlap_us += o
                alone_us += (b - a) - o
        h2d = rec["ms_by_kind"].get("h2d_copy", 0.0) * 1e3
        rec["role"] = ("compute" if "moe_ffn" in rec["ms_by_kind"] else
                       "copy" if h2d > 0.5 * h2d_total else "other")
        if rec["role"] == "copy":
            names = {}
            for a, b, k, name in v:
                if k not in ("h2d_copy", "other_copy"):
                    names[name[:100]] = names.get(name[:100], 0.0) \
                        + (b - a) / 1e3
            rec["kernels_ms"] = names
        streams[str(s)] = rec
    return {"streams": streams, "h2d_ms": h2d_total / 1e3,
            "h2d_concurrent_with_kernels_ms": overlap_us / 1e3,
            "h2d_alone_ms": alone_us / 1e3,
            "h2d_concurrent_share": overlap_us / h2d_total
            if h2d_total else 0.0}


def device_time_summary(prof, wall_ms, h2d_bytes=None):
    """The traced window's device activity: milliseconds by kind, the
    union of all device intervals as the busy time, and, when
    ``h2d_bytes`` is given (the serving loop), the expert copies' rate
    (all host-to-device copy time counted, the few small index uploads
    included)."""
    from torch.autograd import DeviceType
    kinds = {"h2d_copy": 0.0, "other_copy": 0.0, "other_kernels": 0.0}
    kinds.update({kind: 0.0 for _, kind in KINDS})
    top, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name
        kinds[kind_of(name)] += ms
        top[name[:80]] = top.get(name[:80], 0.0) + ms
    check(bool(spans), "the profiler saw no device activity")
    busy_ms = sum(b - a for a, b in merged(spans)) / 1e3
    out = {"wall_ms": wall_ms, "device_ms_by_kind": kinds,
           "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "top_device_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                 [:12])}
    if h2d_bytes is not None:
        check(kinds["h2d_copy"] > 0, "the profiler saw no host-to-device copy")
        out["h2d_expert_bytes"] = h2d_bytes
        out["h2d_GB_per_s"] = h2d_bytes / kinds["h2d_copy"] / 1e6
        out["by_stream"] = stream_split(prof)
    return out


GLUE = (("add", "CUDAFunctor_add"), ("fill", "FillFunctor"))


def glue_sources(prof, top=12):
    """The host ops behind a traced step's elementwise adds and fills
    (``GLUE``: the device kernels whose names hold those fragments): each
    such kernel charged to the op that launched it, that op's nearest
    autograd node (a ``...Backward0``, or the engine's own accumulation)
    and the innermost frame of the port's code on its Python stack (the
    profiler run with ``with_stack``; the autograd engine's ops have no
    Python frame). The ``top`` entries by device ms for each kind, with
    their kernel counts."""
    from torch.autograd import DeviceType
    out = {kind: {} for kind, _ in GLUE}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:
            continue
        for k in ev.kernels:
            kind = next((kd for kd, frag in GLUE if frag in k.name), None)
            if kind is None:
                continue
            node, up = None, ev.cpu_parent
            while up is not None and node is None:
                if "Backward" in up.name or "autograd" in up.name:
                    node = up.name
                up = up.cpu_parent
            frame = next((f for f in (ev.stack or [])
                          if "repro_torch" in f), None)
            key = f"{ev.name} | {node or '-'} | {frame or '-'}"
            rec = out[kind].setdefault(key, [0.0, 0])
            rec[0] += k.duration / 1e3
            rec[1] += 1
    return {kind: {"device_ms": sum(ms for ms, _ in d.values()),
                   "top": [{"op": key, "device_ms": ms, "kernels": n}
                           for key, (ms, n) in sorted(
                               d.items(), key=lambda kv: -kv[1][0])[:top]]}
            for kind, d in out.items()}


def kernel_cases(calls):
    """(name, wrapper(), plain(), library() or None, graph-timed?, bytes,
    flops, shape, library_bwd() or None) for each kernel whose heaviest
    main-path call is in ``calls``. Bytes count each input read once and
    each output written once; flops count the work these inputs need:
    paged attention's keys are the ones the call's positions make
    visible, flash attention's (query, key) pairs the ones its masks
    leave, SSD's the lower triangle of each chunk (the forwards' and
    moe_ffn's are each kernel module's ``cost``, which the dry run's
    counter takes too; the backwards' are each module's ``bwd_cost``,
    which the counter takes for a meta backward). The flash attention
    backward's flops are the least autograd of the forward does per
    visible pair and head: S again (2 hd), dP (2 vd), dV (2 vd), dQ and
    dK (2 hd each), 2.5 times the forward's at hd = vd; its library call
    is SDPA's forward and backward, and ``library_bwd`` SDPA's backward
    alone (``autograd.grad`` over a forward graph kept for it), in the
    call's dtype. The backward's plain version runs in fp32 on the call's
    values (bf16 widened), and its bytes are the call's dtype's; the
    shape records the dtype. The SSD
    backward's flops are its products: a head's U and state term (2 Q P N
    each), dxw and dM (2 P a visible pair each), and a chunk's scores, dC
    and dB (2 N a visible pair each); its bytes read dA, xw, Bm, Cm, dY,
    dS once and write the four gradients."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import moe_gemm, ops
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ssd_chunk as ssd_mod

    if "moe_ffn" in calls:
        x_e, w1, w3, w2, slots = calls["moe_ffn"]
        E, C, d = x_e.shape
        F_ = w1.shape[-1]
        sl = torch.tensor(slots, device="cuda")
        flops, nbytes = moe_gemm.cost(x_e, w1)
        yield ("moe_ffn", lambda: ops.moe_ffn(x_e, w1, w3, w2, slots),
               lambda: moe_gemm.plain(x_e, w1, w3, w2, sl), None, False,
               nbytes, flops, {"E": E, "C": C, "d": d, "F": F_}, None)

    if "paged_attention" in calls:
        q, kp, vp, bt, pos = calls["paged_attention"]
        B, H, hd = q.shape
        bs, KV, T = kp.shape[1], kp.shape[2], bt.shape[1]
        keys = visible_keys(q, kp, vp, bt, pos)
        yield ("paged_attention",
               lambda: ops.paged_attention(q, kp, vp, bt, pos),
               lambda: paged_mod.plain(q, kp, vp, bt, pos), None, True,
               4 * (2 * B * H * hd + 2 * keys * KV * hd + B * T + B),
               4 * keys * H * hd,
               {"B": B, "H": H, "KV": KV, "hd": hd, "bs": bs, "T": T,
                "visible_keys": keys}, None)

    if "flash_attention" in calls:
        q, k, v, kw = calls["flash_attention"]
        B, Sq, H, hd = q.shape
        Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
        causal, window = kw.get("causal", True), kw.get("window", 0)
        pairs = flash_mod.visible_pairs(Sq, Sk, causal, window)
        flops, nbytes = flash_mod.cost(q, k, v, causal=causal, window=window)
        library = None
        if window == 0:   # SDPA has no sliding window
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        # the one-query route's calls are shorter than a host launch:
        # timed in CUDA graphs
        one_query = flash_mod.plan_of(q, k, v) is not None
        yield ("flash_attention",
               lambda: ops.flash_attention(q, k, v, **kw),
               lambda: flash_mod.plain(q, k, v, causal=causal, window=window),
               library, one_query, nbytes, flops,
               {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                "vd": vd, "causal": causal, "window": window,
                "dtype": str(q.dtype), "visible_pairs": pairs,
                "path": "one_query" if one_query else "tiles"}, None)

    if "flash_attention_bwd" in calls:
        q, k, v, dout, kw = calls["flash_attention_bwd"]
        B, Sq, H, hd = q.shape
        Sk, KV, vd = k.shape[1], k.shape[2], v.shape[3]
        causal, window = kw["causal"], kw["window"]
        pairs = flash_mod.visible_pairs(Sq, Sk, causal, window)
        library = library_bwd = None
        if window == 0:   # SDPA's forward and backward: what it costs there
            lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            ldo = dout.transpose(1, 2)

            def forward():
                return F.scaled_dot_product_attention(lq, lk, lv,
                                                      is_causal=causal,
                                                      enable_gqa=True)

            def library():
                return torch.autograd.grad(forward(), (lq, lk, lv), ldo)
            # the graph of one forward on this stream, kept: autograd runs
            # each backward op on its forward op's stream
            kept = forward()

            def library_bwd():
                return torch.autograd.grad(kept, (lq, lk, lv), ldo,
                                           retain_graph=True)
        yield ("flash_attention_bwd",
               lambda: flash_mod.launch_bwd(
                   ops._entry("flash_attention_bwd"), q, k, v, dout, **kw),
               lambda: flash_mod.plain_bwd(q.float(), k.float(), v.float(),
                                           dout.float(), **kw),
               library, False, *reversed(flash_mod.bwd_cost(q, k, v, **kw)),
               {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                "vd": vd, "causal": causal, "window": window,
                "dtype": str(q.dtype), "visible_pairs": pairs}, library_bwd)

    if "ssd_chunk" in calls:
        dA, xw, Bm, Cm = calls["ssd_chunk"]
        G, Q, H = dA.shape
        P, N = xw.shape[3], Bm.shape[2]
        flops, nbytes = ssd_mod.cost(dA, xw, Bm)
        yield ("ssd_chunk", lambda: ops.ssd_chunk(dA, xw, Bm, Cm),
               lambda: ssd_mod.plain(dA, xw, Bm, Cm), None, False,
               nbytes, flops, {"G": G, "Q": Q, "H": H, "P": P, "N": N}, None)

    if "ssd_chunk_bwd" in calls:
        args = calls["ssd_chunk_bwd"]
        G, Q, H = args[0].shape
        P, N = args[1].shape[3], args[2].shape[2]
        yield ("ssd_chunk_bwd",
               lambda: ssd_mod.launch_bwd(ops._entry("ssd_chunk_bwd"), *args),
               lambda: ssd_mod.plain_bwd(*args), None, False,
               *reversed(ssd_mod.bwd_cost(*args[:3])),
               {"G": G, "Q": Q, "H": H, "P": P, "N": N}, None)


def f32_tile_widths(hd, vd):
    """(HK, VN): the q/k and v widths of the fp32 tile forward's
    instantiation for a call (``dispatch_f32`` in csrc/flash_attention.cu),
    at which it runs every k step and value column (panels past the
    call's widths are zeros)."""
    for hk, vn in ((64, 64), (128, 128), (192, 128)):
        if hd <= hk and vd <= vn:
            return hk, vn
    return 256, 256


def pass_flops(name, shape, flops):
    """(flops, the rate they run at): ``flops`` at the tensor-core passes
    the kernel gives each product. fp32 operands: three TF32 passes
    (3xTF32); the fp32 flash forward's wgmma kernel runs S and P.V at its
    instantiation's widths (``f32_tile_widths``: 2 (HK + VN) a visible
    pair and head, three passes each); the fp32 flash backward's wgmma kernels run S and dP twice in
    the rows launch, dQ, and in the keys launch S^T, dP^T, dK and dV: 5 hd
    + 4 vd a visible pair and head, and 6 hd + 4 vd at hd > 64, where S^T
    runs on both warpgroups (1.8-2x the least autograd needs). The flash forward on bf16 inputs: bf16 wgmma passes, S one
    (2 hd a visible pair and head), P.V two (P as bf16 hi + lo: 4 vd).
    The flash backward on bf16 inputs: bf16 wgmma passes, S and dP one
    each in the rows launch's two walks and once more in the keys launch
    (S^T twice where its dK and dV take a warpgroup each, hd > 192), dQ,
    dK and dV two each (P and dS as bf16 hi + lo). The flash forward's
    one-query route: one pass of fp32 FMAs on the CUDA cores."""
    if shape.get("path") == "one_query":
        return flops, FP32_FLOPS_PER_S
    if shape.get("dtype") != "torch.bfloat16":
        if name == "flash_attention_bwd":
            per = 2 * shape["B"] * shape["H"] * shape["visible_pairs"]
            st = 2 if shape["hd"] > 64 else 1   # S^T's warpgroups
            return 3 * per * ((4 + st) * shape["hd"] + 4 * shape["vd"]), \
                TF32_FLOPS_PER_S
        if name == "flash_attention":
            hk, vn = f32_tile_widths(shape["hd"], shape["vd"])
            per = 2 * shape["B"] * shape["H"] * shape["visible_pairs"]
            return 3 * per * (hk + vn), TF32_FLOPS_PER_S
        return 3 * flops, TF32_FLOPS_PER_S
    per = 2 * shape["B"] * shape["H"] * shape["visible_pairs"]
    hd, vd = shape["hd"], shape["vd"]
    if name == "flash_attention":
        return per * (hd + 2 * vd), BF16_FLOPS_PER_S
    return (per * (3 * (hd + vd) + 2 * (2 * hd + vd) + (hd if hd > 192
                                                         else 0)),
            BF16_FLOPS_PER_S)


def agree(name, got, want, tol, what):
    """(max |kernel - plain|, the largest of max |kernel - plain| / max
    |plain|) over the outputs (a tensor or a tuple), raising past the
    tolerance: rtol = atol = ``tol`` elementwise, or ``tol`` times each
    output's largest |plain| for MAX_RELATIVE."""
    import torch
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    worst = worst_rel = 0.0
    for g, w in pairs:
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        top = float(w.abs().max()) if w.numel() else 0.0
        if name in MAX_RELATIVE:
            ok = err <= tol * top
        else:
            ok = torch.allclose(g, w, rtol=tol, atol=tol)
        check(ok, f"{what}: max |kernel - plain| = {err:.3e}, tol {tol}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / top if top > 0 else err)
    return worst, worst_rel


def coverage_checks():
    """Each wrapper against its plain version on the card at MOE_SHAPES,
    PAGED_SHAPES, FLASH_SHAPES (each also against float64 and launched
    twice for bitwise equal outputs;
    the one-query route's also row and head independent,
    ``flash_row_head_independence``), FLASH_BWD_SHAPES (the backward against
    autograd of the plain version, in fp32 and in bf16; bf16 also against
    float64 and launched twice for bitwise equal gradients) and
    SSD_SHAPES, forward and backward
    (inputs from a seeded numpy generator; moe weights in E + 1 slots read
    in reverse order; one paged row with pos -1; the SSD steps at
    SSD_ORACLE_SHAPE against float64). Raises on the first disagreement;
    returns one record per shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import moe_gemm, ops
    from repro_torch.kernels import paged_attention as paged_mod
    from repro_torch.kernels import ssd_chunk as ssd_mod

    rng = np.random.default_rng(SEED)

    def rand(shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    out = []

    def held(name, shape, got, want, tol=None):
        tol = TOL[name] if tol is None else tol
        err, rel = agree(name, got, want, tol, f"{name} at {shape}")
        out.append({"name": name, "shape": shape, "max_abs_err": err,
                    "max_err_over_max_plain": rel, "tol": tol})

    for E, C, d, F in MOE_SHAPES:
        x = rand((E, C, d), 0.5)
        w1, w3 = rand((E + 1, d, F), 0.05), rand((E + 1, d, F), 0.05)
        w2 = rand((E + 1, F, d), 0.05)
        slots = list(range(E, 0, -1))
        held("moe_ffn", [E, C, d, F], ops.moe_ffn(x, w1, w3, w2, slots),
             moe_gemm.plain(x, w1, w3, w2, torch.tensor(slots, device="cuda")))
    for B, H, KV, hd, N, bs, T in PAGED_SHAPES:
        q = rand((B, H, hd))
        kp, vp = rand((N, bs, KV, hd)), rand((N, bs, KV, hd))
        bt = torch.from_numpy(
            rng.integers(0, N, (B, T)).astype(np.int32)).cuda()
        pos = torch.from_numpy(
            rng.integers(0, T * bs, (B,)).astype(np.int32)).cuda()
        if B > 2:
            pos[-1] = -1   # no visible key: uniform over the row's keys
        held("paged_attention", [B, H, KV, hd, N, bs, T],
             ops.paged_attention(q, kp, vp, bt, pos),
             paged_mod.plain(q, kp, vp, bt, pos))
    S = paged_mod.KEYS_PER_SPLIT
    at = {"S": S, "S-1": S - 1, "2S": 2 * S}
    for keys, where in PAGED_LONG:
        pos_list = [at.get(w, w) for w in where]
        q, kp, vp, bt, pos = paged_inputs(rand, rng, len(pos_list), keys,
                                          pos_list)
        held("paged_attention", [len(pos_list), 32, 8, 128, keys,
                                  pos_list], ops.paged_attention(
                                      q, kp, vp, bt, pos),
             paged_mod.plain(q, kp, vp, bt, pos))
    for B, Sq, Sk, H, KV, hd, vd, causal, window, dt in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q = rand((B, Sq, H, hd)).to(dtype)
        k, v = rand((B, Sk, KV, hd)).to(dtype), rand((B, Sk, KV, vd)).to(dtype)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        check(got.dtype == dtype, f"flash_attention: output {got.dtype}")
        # bf16: against the fp32 plain version on the same (bf16) values
        want = flash_mod.plain(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
        held("flash_attention", [B, Sq, Sk, H, KV, hd, vd, causal, window,
                                 dt], got, want,
             BF16_TOL if dtype == torch.bfloat16 else None)
        kw = dict(causal=causal, window=window)
        if flash_mod.plan_of(q, k, v) is not None:
            out[-1].update(one_query_checks(ops, q, k, v, got, kw,
                                            out[-1]["shape"]))
        else:
            out[-1]["vs_float64"] = fwd_against_float64(ops, q, k, v, kw)
            out[-1]["bitwise_repeat"] = fwd_repeat_bitwise(ops, q, k, v, kw)
    for dt in ("float32", "bfloat16"):
        for B, Sq, Sk, H, KV, hd, vd, causal, window in FLASH_BWD_SHAPES:
            q, k = rand((B, Sq, H, hd)), rand((B, Sk, KV, hd))
            v, dout = rand((B, Sk, KV, vd)), rand((B, Sq, H, vd))
            q, k, v, dout = (t.to(getattr(torch, dt)) for t in (q, k, v, dout))
            kw = dict(causal=causal, window=window)
            shape = [B, Sq, Sk, H, KV, hd, vd, causal, window]
            got = flash_mod.launch_bwd(ops._entry("flash_attention_bwd"), q,
                                       k, v, dout, **kw)
            # bf16: against the fp32 plain version on the same values
            held("flash_attention_bwd", shape + [dt], got,
                 flash_mod.plain_bwd(q.float(), k.float(), v.float(),
                                     dout.float(), **kw),
                 BF16_TOL if dt == "bfloat16" else None)
            out[-1]["vs_float64"] = bwd_against_float64(ops, q, k, v, dout,
                                                        kw)
            out[-1]["bitwise_repeat"] = bwd_repeat_bitwise(ops, q, k, v,
                                                           dout, kw)
    for G, Q, H, P, N, scale in SSD_SHAPES + [SSD_ORACLE_SHAPE]:
        dA = -rand((G, Q, H), scale).abs()
        xw, Bm, Cm = rand((G, Q, H, P)), rand((G, Q, N)), rand((G, Q, N))
        oracle = (G, Q, H, P, N, scale) == SSD_ORACLE_SHAPE
        want = (ssd_float64 if oracle else ssd_mod.plain)(dA, xw, Bm, Cm)
        held("ssd_chunk", [G, Q, H, P, N, scale],
             ops.ssd_chunk(dA, xw, Bm, Cm), want)
        if oracle:
            out[-1]["against"] = "float64"
    for G, Q, H, P, N, scale in SSD_SHAPES + [SSD_ORACLE_SHAPE]:
        args = (-rand((G, Q, H), scale).abs(), rand((G, Q, H, P)),
                rand((G, Q, N)), rand((G, Q, N)), rand((G, Q, H, P)),
                rand((G, H, P, N)))
        oracle = (G, Q, H, P, N, scale) == SSD_ORACLE_SHAPE
        want = (ssd_bwd_float64 if oracle else ssd_mod.plain_bwd)(*args)
        held("ssd_chunk_bwd", [G, Q, H, P, N, scale],
             ssd_mod.launch_bwd(ops._entry("ssd_chunk_bwd"), *args),
             tuple(w.float() for w in want))
        if oracle:
            out[-1]["against"] = "float64"
    return out


def one_query_cross(floor_ms):
    """The engines' one-query cross-attention calls, seeded, no mask, in
    fp32 (ONE_QUERY_CROSS) and in bf16 (ONE_QUERY_CROSS_BF16): the route
    the call took (``ops.route_counts`` around it: one), the kernel held
    against its plain version (the fp32 plain version on the same values:
    TOL, BF16_TOL for bf16) and by ``one_query_checks``, then the kernel,
    the tile kernel of its dtype (``keys_per_split`` 0), the plain
    version and SDPA in the call's dtype each timed in a CUDA graph (the
    calls are shorter than a launch from the host), beside the bound: K
    and V read once, at the memory rate, against the route's fp32 FMAs at
    the fp32-core rate. Returns (fp32 records, bf16 records)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 12)
    fn = ops._entry("flash_attention")
    kw = dict(causal=False, window=0)

    def rand(shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(dtype)

    def timed(call):
        return device_ms(call, 20, graph=True)

    def record(B, Sk, H, hd, dtype):
        q, k, v = (rand(s, dtype) for s in ((B, 1, H, hd), (B, Sk, H, hd),
                                            (B, Sk, H, hd)))
        what = f"one-query cross {B, Sk, H, hd} {dtype}"
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, **kw)
        routes = ops.route_counts()["flash_attention_one_query"]
        check(routes == 1, f"{what}: route count {routes}, expected the "
                           f"one-query route")
        tol = BF16_TOL if dtype == torch.bfloat16 else TOL["flash_attention"]
        err, rel = agree("flash_attention", got,
                         flash_mod.plain(q.float(), k.float(), v.float(),
                                         **kw), tol, what)
        checks = one_query_checks(ops, q, k, v, got, kw, what)
        S = flash_mod.plan_of(q, k, v)
        flops, nbytes = flash_mod.cost(q, k, v, **kw)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = timed(lambda: ops.flash_attention(q, k, v, **kw))
        return {
            "shape": {"B": B, "Sq": 1, "Sk": Sk, "H": H, "KV": H, "hd": hd,
                      "vd": hd, "causal": False, "dtype": str(dtype)},
            "keys_per_split": S,
            "splits": len(flash_mod.one_query_splits(1, Sk, False, 0, S)),
            "max_abs_err": err, "max_err_over_max_plain": rel, "tol": tol,
            **checks, "ms": ms,
            "tiles_ms": timed(lambda: flash_mod.launch(
                fn, q, k, v, keys_per_split=0, **kw)),
            "plain_ms": timed(lambda: flash_mod.plain(q, k, v, **kw)),
            "library_ms": timed(
                lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": f"{FP32_PEAK[0]}, {FP32_FLOPS_PER_S / 1e12:g} "
                          f"TFLOP/s",
            "share_of_bound": max(t_bytes, t_ops) * 1e3 / ms,
            "bytes": nbytes, "flops": flops, "launch_floor_ms": floor_ms}

    return ([record(*s, torch.float32) for s in ONE_QUERY_CROSS],
            [record(*s, torch.bfloat16) for s in ONE_QUERY_CROSS_BF16])


def one_query_checks(ops, q, k, v, got, kw, what):
    """The one-query route at a call whose output is ``got``: max |got -
    float64| over max |float64| (``flash_out_float64``, within TOL; on
    bf16 inputs within BF16_F64_TOL: fp32 FMAs, one rounding to bf16 at
    the store), two launches bitwise equal (``fwd_repeat_bitwise``), and
    the call's last row and last two KV heads in calls of their own
    bitwise equal (``flash_row_head_independence``). Returns the record's
    fields."""
    import torch
    kw = dict(causal=kw.get("causal", True), window=kw.get("window", 0))
    f64 = flash_out_float64(q, k, v, **kw)
    vs64 = float((got.double() - f64).abs().max() / f64.abs().max())
    tol = (BF16_F64_TOL if q.dtype == torch.bfloat16
           else TOL["flash_attention"])
    check(vs64 <= tol, f"flash_attention one-query route, {what}, vs "
                       f"float64: {vs64:.3e}, tol {tol}")
    return {"route": "one_query", "vs_float64": vs64, "f64_tol": tol,
            "bitwise_repeat": fwd_repeat_bitwise(ops, q, k, v, kw),
            "independence": flash_row_head_independence(ops, q, k, v, kw)}


def flash_row_head_independence(ops, q, k, v, kw, row=-1):
    """A flash attention call's row ``row`` in a call of its own, and its
    last two KV heads' query heads (all of them where KV is 1) in a call
    of their own, as a rank of the model axis runs them: each bitwise
    equal to the same outputs of the whole call (the one-query route's
    splits depend on neither B nor H)."""
    import torch
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    G, r, j = H // KV, row % B, max(0, KV - 2)
    kw = dict(causal=kw.get("causal", True), window=kw.get("window", 0))
    whole = ops.flash_attention(q, k, v, **kw)
    alone = ops.flash_attention(*(t[r:r + 1].contiguous() for t in (q, k, v)),
                                **kw)
    cut = ops.flash_attention(q[:, :, j * G:].contiguous(),
                              k[:, :, j:].contiguous(),
                              v[:, :, j:].contiguous(), **kw)
    torch.cuda.synchronize()
    check(torch.equal(whole[r:r + 1], alone)
          and torch.equal(whole[:, :, j * G:], cut),
          f"flash_attention at {tuple(q.shape)} over {k.shape[1]} keys: row "
          f"{r} alone or heads {j * G}..{H - 1} cut from the call differ")
    return {"row": r, "of_rows": B, "heads": [j * G, H], "of_heads": H,
            "bitwise": True}


def one_query_independence():
    """The engines' one-query calls at their widths over 8 rows
    (Llama-3.2-Vision's 1601 patches and 32 heads of 128, Whisper-tiny's
    1500 frames and 6 heads of 64): row 3 alone, as one of the 8 rows, and
    in a call cut to 2 of its heads (a (16, 16) rank's cross call), all
    bitwise equal (``flash_row_head_independence``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 13)
    out = []
    for B, Sk, H, hd in ((8, 1601, 32, 128), (8, 1500, 6, 64)):
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).cuda() for s in ((B, 1, H, hd), (B, Sk, H, hd),
                                          (B, Sk, H, hd)))
        rec = flash_row_head_independence(
            ops, q, k, v, dict(causal=False, window=0), row=3)
        out.append({"shape": [B, 1, Sk, H, H, hd, hd], **rec})
    return {"one_query_independence": out}


def one_query_sweep(floor_ms, dtype_name="float32"):
    """The one-query route's two choices in one dtype (fp32 or bf16),
    each timed in a CUDA graph of 20 launches (seeded): its split length
    at the engines' calls (ONE_QUERY_CROSS; in bf16 ONE_QUERY_CROSS_BF16,
    with the (16, 16) rank's call) over ONE_QUERY_SPLIT_SWEEP
    (None where a split's rows do not fit shared memory and the launch is
    refused), and the rows a KV head it takes: the route (at its plan's
    split length) beside the tile kernel of the dtype at Sq·G in
    ONE_QUERY_ROW_SWEEP, over G at one query and over Sq at G 1
    (ONE_QUERY_ROW_CALLS: (over, B, KV); 1601 keys, KV heads of 128, no
    mask). ``sweep_cut``: the most rows up to which the route beat the
    tile kernel at every count, in every sweep, beside the cut the port
    uses (``ONE_QUERY_ROWS``, ``ONE_QUERY_ROWS_BF16``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 14)
    fn = ops._entry("flash_attention")
    kw = dict(causal=False, window=0)
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(dtype)

    def timed(q, k, v, S):
        try:
            return device_ms(lambda: flash_mod.launch(
                fn, q, k, v, keys_per_split=S, **kw), 20, graph=True)
        except RuntimeError:   # refused: the split does not fit
            return None

    out = {"launch_floor_ms": floor_ms, "dtype": dtype_name,
           "cut": (flash_mod.ONE_QUERY_ROWS_BF16 if bf16
                   else flash_mod.ONE_QUERY_ROWS),
           "split_bytes": (flash_mod.ONE_QUERY_SPLIT_BYTES_BF16 if bf16
                           else flash_mod.ONE_QUERY_SPLIT_BYTES)}
    for B, Sk, H, hd in ONE_QUERY_CROSS_BF16 if bf16 else ONE_QUERY_CROSS:
        q, k, v = rand(B, 1, H, hd), rand(B, Sk, H, hd), rand(B, Sk, H, hd)
        out[f"split_{B}x{Sk}x{H}x{hd}"] = {
            "plan": flash_mod.plan_of(q, k, v),
            **{f"S{S}": timed(q, k, v, S) for S in ONE_QUERY_SPLIT_SWEEP}}
    Sk, hd = 1601, 128
    S = flash_mod.one_query_plan(1, Sk, 1, 1, hd, hd, dtype)
    cut = {}
    for over, B, KV in ONE_QUERY_ROW_CALLS:
        k, v = rand(B, Sk, KV, hd), rand(B, Sk, KV, hd)
        rows = []
        for R in ONE_QUERY_ROW_SWEEP:
            G, Sq = (R, 1) if over == "G" else (1, R)
            q = rand(B, Sq, KV * G, hd)
            rows.append({"rows": R, "Sq": Sq, "G": G,
                         "one_query_ms": timed(q, k, v, S),
                         "tiles_ms": timed(q, k, v, 0)})
        name = f"rows_over_{over}_{B}x{KV}"
        out[name] = rows
        wins = [None not in (r["one_query_ms"], r["tiles_ms"])
                and r["one_query_ms"] < r["tiles_ms"] for r in rows]
        n = wins.index(False) if False in wins else len(wins)
        cut[name] = ONE_QUERY_ROW_SWEEP[n - 1] if n else 0
        del k, v
    out["sweep_cut"] = min(cut.values())
    out["sweep_cut_by"] = cut
    return out


def paged_inputs(rand, rng, B, keys, pos, extra=0):
    """Mixtral-width paged inputs (H 32, KV 8, hd 128, 16-key blocks): B
    rows of ``keys`` keys through random tables into a pool of
    keys / 16 + 8 blocks, ``extra`` more table columns, positions ``pos``."""
    import numpy as np
    import torch
    T, N = keys // 16, keys // 16 + 8
    q = rand((B, 32, 128))
    kp, vp = rand((N, 16, 8, 128)), rand((N, 16, 8, 128))
    bt = torch.from_numpy(
        rng.integers(0, N, (B, T + extra)).astype(np.int32)).cuda()
    return q, kp, vp, bt, torch.tensor(pos, dtype=torch.int32, device="cuda")


def paged_batch_independence():
    """The same row (pos 1000 of 4096 keys) through ``ops.paged_attention``
    alone, as row 3 of 16 rows with other positions, and with a table two
    blocks wider: the three outputs must be bitwise equal."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 2)

    def rand(shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    pos = [int(p) for p in rng.integers(0, 4096, 16)]
    pos[3] = 1000
    q, kp, vp, bt, pos = paged_inputs(rand, rng, 16, 4096, pos, extra=2)
    narrow = bt[:, :-2].contiguous()
    batch = ops.paged_attention(q, kp, vp, narrow, pos)[3]
    alone = ops.paged_attention(q[3:4].contiguous(), kp, vp,
                                narrow[3:4].contiguous(),
                                pos[3:4].contiguous())[0]
    wide = ops.paged_attention(q, kp, vp, bt, pos)[3]
    torch.cuda.synchronize()
    check(torch.equal(batch, alone) and torch.equal(batch, wide),
          "paged_attention: row 3 differs alone / in a batch of 16 / with a "
          "wider table")
    return {"paged_batch_independence": "bitwise", "rows": 16, "keys": 4096,
            "pos": 1000, "wider_table_blocks": 2}


def paged_split_sweep(calls, floor_ms):
    """The paged kernel timed at split lengths SPLIT_SWEEP (20 launches in
    a CUDA graph) on the main path's heaviest call and on 1 and 4 rows of
    2048 and 4096 keys (every row full): what chose KEYS_PER_SPLIT."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as paged_mod
    rng = np.random.default_rng(SEED + 3)

    def rand(shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    q, kp, vp, bt, pos = calls["paged_attention"]
    cases = {"main": (q, kp, vp, bt.to(torch.int32).contiguous(),
                      pos.to(torch.int32).contiguous())}
    for B in (1, 4):
        for keys in (2048, 4096):
            cases[f"{B}x{keys}"] = paged_inputs(rand, rng, B, keys,
                                                [keys - 1] * B)
    fn = ops._entry("paged_attention")
    out = {"launch_floor_ms": floor_ms,
           "kernel_split": paged_mod.KEYS_PER_SPLIT}
    for name, args in cases.items():
        out[name] = {f"S{S}": device_ms(
            lambda: paged_mod.launch(fn, *args, keys_per_split=S), 20,
            graph=True) for S in SPLIT_SWEEP}
    return out


def ssd_float64(dA, xw, Bm, Cm):
    """The sums of ``ref.ssd_chunk_ref`` in float64, one head at a time,
    rounded to fp32 at the end."""
    import torch
    dA, xw, Bm, Cm = (t.double() for t in (dA, xw, Bm, Cm))
    Q = dA.shape[1]
    cum = torch.cumsum(dA, dim=1)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=dA.device).tril()
    scores = torch.einsum("gin,gjn->gij", Cm, Bm)
    y = torch.stack([torch.einsum(
        "gij,gjp->gip", torch.where(
            keep, torch.exp(cum[:, :, None, h] - cum[:, None, :, h]), 0.0)
        * scores, xw[:, :, h]) for h in range(dA.shape[2])], dim=2)
    s = torch.einsum("gjh,gjn,gjhp->ghpn", torch.exp(cum[:, -1:] - cum), Bm,
                     xw)
    return y.float(), s.float()


def ssd_bwd_float64(dA, xw, Bm, Cm, dY, dS):
    """Autograd of ``ssd_float64``'s sums, kept in float64 (the exponent
    masked above the diagonal, as the plain version masks it): the four
    input gradients, float64."""
    import torch
    leaves = [t.detach().double().requires_grad_() for t in (dA, xw, Bm, Cm)]
    a, x, b, c = leaves
    Q = a.shape[1]
    cum = torch.cumsum(a, dim=1)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    scores = torch.einsum("gin,gjn->gij", c, b)
    y = torch.stack([torch.einsum("gij,gjp->gip", torch.exp(torch.where(
        keep, cum[:, :, None, h] - cum[:, None, :, h], -float("inf")))
        * scores, x[:, :, h]) for h in range(a.shape[2])], dim=2)
    s = torch.einsum("gjh,gjn,gjhp->ghpn", torch.exp(cum[:, -1:] - cum), b, x)
    return torch.autograd.grad((y, s), leaves, (dY.double(), dS.double()))


def ssd_bwd_checks(ops, args):
    """The SSD backward kernel and the plain version's autograd against
    ``ssd_bwd_float64`` on a recorded call (each error over the gradient's
    max |float64|; the kernel must stay within TOL), and two launches of
    the kernel, which must give bitwise equal gradients (no atomics)."""
    import torch
    from repro_torch.kernels import ssd_chunk as ssd_mod
    fn = ops._entry("ssd_chunk_bwd")
    got = ssd_mod.launch_bwd(fn, *args)
    again = ssd_mod.launch_bwd(fn, *args)
    plain = ssd_mod.plain_bwd(*args)
    want = ssd_bwd_float64(*args)

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    rep = {}
    for name, g, pl, w in zip(("d_dA", "d_xw", "d_Bm", "d_Cm"), got, plain,
                              want):
        rep[name] = {"kernel": rel(g, w), "plain": rel(pl, w)}
        check(rep[name]["kernel"] <= TOL["ssd_chunk_bwd"],
              f"ssd_chunk_bwd {name} vs float64: {rep[name]}")
    rep["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
    check(rep["bitwise_repeat"], "ssd_chunk_bwd: two launches on the same "
                                 "inputs differ")
    return rep


def flash_float64(q, k, v, dout, *, causal, window):
    """``flash_attention.plain`` and its autograd in float64 (the plain
    version itself computes in fp32): (out, (dq, dk, dv)), all float64."""
    import math
    import torch
    q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    kk, vv = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return out.detach(), torch.autograd.grad(out, (q, k, v), dout.double())


def bwd_against_float64(ops, q, k, v, dout, kw):
    """The backward kernel and the plain version's autograd against
    ``flash_float64`` on the first batch row of a recorded call, and the
    forward kernel's output too (the backward forms D from its own
    products because the forward's 3xTF32 O, read into D, moved dQ off by
    ~1e-4 x max at Qwen1.5-0.5B's first layer): each error over the
    output's max |float64|. The kernel must stay within TOL of it, or
    within BF16_F64_TOL on bf16 inputs (float64 and the plain version,
    in fp32, on the same bf16 values); on bf16 inputs the forward's
    output must too (one rounding to bf16 at its store)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v, dout = (t[:1].contiguous() for t in (q, k, v, dout))
    out64, want = flash_float64(q, k, v, dout, **kw)
    got = flash_mod.launch_bwd(ops._entry("flash_attention_bwd"), q, k, v,
                               dout, **kw)
    check(all(g.dtype == q.dtype for g in got),
          f"flash_attention_bwd: gradients in {[g.dtype for g in got]}")
    plain = flash_mod.plain_bwd(q.float(), k.float(), v.float(),
                                dout.float(), **kw)
    tol = (BF16_F64_TOL if q.dtype == torch.bfloat16
           else TOL["flash_attention_bwd"])

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    rep = {"dtype": str(q.dtype), "tol": tol,
           "forward_out": rel(ops.flash_attention(q, k, v, **kw), out64)}
    if q.dtype == torch.bfloat16:
        check(rep["forward_out"] <= BF16_F64_TOL,
              f"flash_attention (bf16) vs float64: {rep['forward_out']}")
    for name, g, pl, w in zip(("dq", "dk", "dv"), got, plain, want):
        rep[name] = {"kernel": rel(g, w), "plain": rel(pl, w)}
        check(rep[name]["kernel"] <= tol,
              f"flash_attention_bwd {name} vs float64: {rep[name]}")
    return rep


def bwd_repeat_bitwise(ops, q, k, v, dout, kw):
    """Two launches of the backward kernel on a recorded call's inputs:
    dq, dk and dv must be bitwise equal (no atomics, every sum in a fixed
    order)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    fn = ops._entry("flash_attention_bwd")
    first = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
    second = flash_mod.launch_bwd(fn, q, k, v, dout, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, "flash_attention_bwd: two launches on the same inputs "
                "differ")
    return same


def flash_out_float64(q, k, v, *, causal, window):
    """The attention ``flash_mod.plain`` computes, in float64, a few query
    heads at a time (at most 2^27 scores on the card at once)."""
    import math
    import torch
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= qp - kp < window
    step = max(1, 2 ** 27 // (B * Sq * Sk))
    out = []
    for h0 in range(0, H, step):
        heads = torch.arange(h0, min(H, h0 + step), device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, heads].double(),
                         k[:, :, heads // G].double()) / math.sqrt(hd)
        p = torch.softmax(torch.where(keep, s, -1e30), dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p,
                                v[:, :, heads // G].double()))
    return torch.cat(out, dim=2)


def fwd_against_float64(ops, q, k, v, kw):
    """The forward kernel and the plain version (fp32, on the same values)
    against ``flash_out_float64`` at a call: each max |error| over max
    |float64|. A bf16 kernel must stay within BF16_F64_TOL (one rounding
    to bf16 at its store over P.V with P as bf16 hi + lo), an fp32 one
    within TOL["flash_attention"]."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    kw = dict(causal=kw.get("causal", True), window=kw.get("window", 0))
    got = flash_mod.launch(ops._entry("flash_attention"), q, k, v, **kw)
    want = flash_out_float64(q, k, v, **kw)
    plain = flash_mod.plain(q.float(), k.float(), v.float(), **kw)

    def rel(a):
        return float((a.double() - want).abs().max() / want.abs().max())

    tol = (BF16_F64_TOL if q.dtype == torch.bfloat16
           else TOL["flash_attention"])
    rep = {"kernel": rel(got), "plain": rel(plain), "tol": tol}
    check(got.dtype == q.dtype and rep["kernel"] <= tol,
          f"flash_attention ({q.dtype}) vs float64: {rep}")
    return rep


def fwd_repeat_bitwise(ops, q, k, v, kw):
    """Two launches of the forward kernel on a call's inputs: the outputs
    must be bitwise equal (no atomics, every sum in a fixed order)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    fn = ops._entry("flash_attention")
    kw = dict(causal=kw.get("causal", True), window=kw.get("window", 0))
    same = torch.equal(flash_mod.launch(fn, q, k, v, **kw),
                       flash_mod.launch(fn, q, k, v, **kw))
    check(same, "flash_attention: two launches on the same inputs differ")
    return same


def served_run(srv, rids, step_ms, step_h2d, loop_ms, launches,
               kernels=("moe_ffn", "paged_attention")):
    """A serving run's record, taken before anything else runs on the
    server: what overlap must not change (tokens, the trace's functional
    rows, stats() off the clock keys, repr so that NaN equals NaN; the
    per-step H2D bytes), the clock, step times, loop time, launches and
    cache counters. Each of ``kernels`` must have launched."""
    for name in kernels:
        check(launches[name] > 0,
              f"{name}: the serving run never launched its kernel")
    stats = srv.stats()
    return {"tokens": [srv.result(r) for r in rids],
            "rows": [tuple(getattr(s, f) for f in FUNCTIONAL)
                     for s in srv.trace.steps],
            "stats": {k: repr(v) for k, v in stats.items()
                      if k not in CLOCK_KEYS},
            "clock": {k: stats[k] for k in CLOCK_KEYS},
            "step_ms": step_ms, "step_h2d": step_h2d, "loop_ms": loop_ms,
            "launches": launches,
            "counts": {k: stats[k] for k in ("hits", "misses", "prefetches")}}


def overlap_run(params, cfg, prompts, ops, server_kw, store, off_srv, off,
                prof=None, kernels=("moe_ffn", "paged_attention")):
    """The staggered workload once more with ``overlap=True`` on the
    masters ``store`` of the ``overlap=False`` server ``off_srv``, whose
    run is ``off`` (``served_run``, ``kernels`` launched): every install
    on the copy stream (``serve``), and the same tokens, functional trace
    rows, stats() off the clock keys, per-step H2D bytes and, at the end,
    every slot bitwise. Returns (report, record)."""
    import statistics
    import torch
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    with reusing(store):
        srv = ContinuousOffloadServer(params, cfg, quant=store.quant,
                                      **{**server_kw, "overlap": True})
    rids, launches, step_ms, step_h2d, _, loop_ms = serve(srv, prompts, ops,
                                                          prof)
    on = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches,
                    kernels)
    what = f"quant={store.quant} overlap on vs off"
    for key in ("tokens", "rows", "stats", "step_h2d"):
        check(on[key] == off[key], f"{what}: {key} differ")
    torch.cuda.synchronize()
    slots = 0
    for c_off, c_on in zip(off_srv.engine.caches, srv.engine.caches):
        check(c_on.slot_of == c_off.slot_of,
              f"{what}: layer {c_on.layer} slot maps differ")
        for k, buf in c_off.buffers.items():
            check(torch.equal(c_on.buffers[k], buf),
                  f"{what}: layer {c_on.layer} {k} slots differ")
        slots += len(c_on.slot_of)
    rep = {"quant": store.quant, "steps": len(step_ms),
           "overlap": [False, True],
           "step_ms_median": [statistics.median(off["step_ms"]),
                              statistics.median(step_ms)],
           "step_ms_max": [max(off["step_ms"]), max(step_ms)],
           "first_step_ms": [off["step_ms"][0], step_ms[0]],
           "loop_ms": [off["loop_ms"], loop_ms],
           "exposed_transfer_frac": [off["clock"]["exposed_transfer_frac"],
                                     on["clock"]["exposed_transfer_frac"]],
           "sim_time_s": [off["clock"]["sim_time_s"],
                          on["clock"]["sim_time_s"]],
           "h2d_expert_bytes": sum(step_h2d), "counts": on["counts"],
           "launches": launches, "slots_bitwise": slots,
           "equal": ["tokens", "functional_trace_rows", "stats_off_clock",
                     "step_h2d_bytes", "slots_bitwise"]}
    if prof is not None:
        rep["profile"] = device_time_summary(prof, loop_ms, sum(step_h2d))
        split = rep["profile"]["by_stream"]["streams"].values()
        copy = [r for r in split if r["role"] == "copy"]
        check(len(copy) == 1, f"{what}: copy streams in the trace: {split}")
        check(bool(copy[0].get("kernels_ms")) == (store.quant == "int8"),
              f"{what}: kernels on the copy stream: {copy[0]}")
    del srv
    gc.collect()
    return rep, on


def learned_serving(params, cfg, prompts, ops, server_kw, store, model,
                    lfu):
    """The staggered workload on the masters ``store`` with
    ``policy="learned"``, ``prefetch="learned"`` (``model``, trained from
    the fp32 serving run's trace) and ``overlap=True``: bytes == trace
    (``serve``), both kernels launched, server tokens == ``generate``.
    Reports its step times and cache counters beside ``lfu``'s (the LFU +
    speculative run with overlap on, same masters)."""
    import statistics
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    with reusing(store):
        srv = ContinuousOffloadServer(
            params, cfg, quant=store.quant,
            **{**server_kw, "policy": "learned", "prefetch": "learned",
               "overlap": True, "learned_model": model})
    rids, launches, step_ms, step_h2d, _, loop_ms = serve(srv, prompts, ops)
    run = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches)
    for p, out in zip(prompts, run["tokens"]):
        want = srv.engine.generate(p, NEW_TOKENS)
        check(out == want, f"learned: server {out[PROMPT_LEN:]} != generate "
                           f"{want[PROMPT_LEN:]} for prompt {p}")
    del srv
    gc.collect()
    return {"quant": store.quant, "policy": "learned",
            "prefetch": "learned", "overlap": True,
            "model_confidence": model.confidence,
            "model_samples": model.meta["n_samples"],
            "steps": len(step_ms), "server_equals_generate": True,
            "h2d_equals_trace": True, "launches": launches,
            "step_ms_median": statistics.median(step_ms),
            "step_ms_max": max(step_ms), "loop_ms": loop_ms,
            "h2d_expert_bytes": sum(step_h2d), "counts": run["counts"],
            "lfu_spec": {"step_ms_median": statistics.median(lfu["step_ms"]),
                         "step_ms_max": max(lfu["step_ms"]),
                         "loop_ms": lfu["loop_ms"],
                         "h2d_expert_bytes": sum(lfu["step_h2d"]),
                         "counts": lfu["counts"]},
            "new_tokens": [o[PROMPT_LEN:] for o in run["tokens"]]}


def tier_serving(params, cfg, ops, store, card):
    """Phase 4d (see the module docstring) on the masters ``store``.
    Every server is built, run and freed one at a time. Returns the
    ``tiers`` report; raises on a failed check."""
    import statistics
    import torch
    from repro_torch.core.paged_kv import PagedKVCache
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    t_phase = time.perf_counter()
    base, prices, prompts = tier_plan(cfg, store.quant)
    budget = base["hbm_budget_bytes"]
    slot_price, block_price = prices["slot"], prices["block"]
    # what one block of the fp32 pool holds: K and V of every layer
    real_block = (TIER_BLOCK_SIZE * cfg.num_kv_heads * cfg.head_dim * 4 * 2
                  * cfg.num_layers)
    expert_bytes = store.expert_nbytes((0, 0))
    compute = torch.cuda.current_stream()

    def no_host_sync(fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    def run(generate=False, **kw):
        moves = []
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        with reusing(store):
            srv = ContinuousOffloadServer(params, cfg, **{**base, **kw})
        torch.cuda.synchronize()
        built = torch.cuda.memory_allocated() - mem0
        check(srv.engine.caches[0].n_slots == TIER_SLOTS
              and srv.paged.num_blocks == TIER_BLOCKS,
              f"the plan gave {srv.engine.caches[0].n_slots} slots and "
              f"{srv.paged.num_blocks} blocks")
        srv._park_kv = no_host_sync(srv._park_kv)
        srv._restore_kv = no_host_sync(srv._restore_kv)
        rids = [srv.submit(p, max_new=TIER_TOKENS) for p in prompts]
        step_ms, step_h2d, logits = [], [], []
        with timed_moves(moves):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t_loop = time.perf_counter()
            while srv.pending:
                h2d = sum(c.bytes_transferred for c in srv.engine.caches)
                rows = len(srv.trace.steps)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(srv._logits.clone())
                step_h2d.append(sum(c.bytes_transferred
                                    for c in srv.engine.caches) - h2d)
                moved = sum(len(r.misses) + len(r.prefetched)
                            for r in srv.trace.steps[rows:])
                check(step_h2d[-1] == moved * expert_bytes,
                      f"tiers {kw}: step {len(step_ms)}: {step_h2d[-1]} H2D "
                      f"bytes, the trace moved {moved} experts")
            loop_ms = (time.perf_counter() - t_loop) * 1e3
            launches = ops.launch_counts()
        for name in ("moe_ffn", "paged_attention"):
            check(launches[name] > 0, f"tiers {kw}: {name} never launched")
        copy = srv.engine.copy_stream
        where = copy if copy is not None else compute
        check(all(m[1] == where for m in moves),
              f"tiers {kw}: park/resume copies ran on "
              f"{sorted({str(m[1]) for m in moves})}, expected {where}")
        check(all(m[3] for m in moves), f"tiers {kw}: unpinned host KV")
        stats = srv.stats()
        rec = {"tokens": [srv.result(r) for r in rids],
               "rows": [tuple(getattr(r, f) for f in FUNCTIONAL
                              + ("miss_tiers",)) for r in srv.trace.steps],
               "events": [dataclasses.astuple(dataclasses.replace(
                   e, sim_time=0.0)) for e in srv.trace.tier_events],
               "stats": {k: repr(v) for k, v in stats.items()
                         if k not in TIER_CLOCK_KEYS},
               "raw": stats, "logits": logits, "step_ms": step_ms,
               "step_h2d": step_h2d, "loop_ms": loop_ms,
               "launches": launches, "built_bytes": built,
               "slot_bytes": sum(b.nbytes for c in srv.engine.caches
                                 for b in c.buffers.values()),
               "pool_bytes": sum(t.nbytes for layer in srv.state["layers"]
                                 for t in layer.values()),
               "staging_bytes": sum(t.nbytes for c in srv.engine.caches[:1]
                                    for pair in c.staging.values()
                                    for t in pair)}
        torch.cuda.synchronize()
        rec.update(move_times(moves))
        if generate:
            for p, out in zip(prompts, rec["tokens"]):
                want = srv.engine.generate(p, TIER_TOKENS)
                check(out == want, f"tiers: server {out[TIER_PROMPT_LEN:]} "
                                   f"!= generate {want[TIER_PROMPT_LEN:]}")
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    def same(a, b, what, keys=("tokens", "rows", "events", "stats",
                                "step_h2d")):
        for key in keys:
            check(a[key] == b[key], f"tiers {what}: {key} differ")
        check(len(a["logits"]) == len(b["logits"]) and all(
            torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])),
            f"tiers {what}: logits differ")

    def sleep_first(fn):
        def call(*args, **kw):
            torch.cuda._sleep(SLEEP_CYCLES)
            return fn(*args, **kw)
        return call

    def zero_then_sleep(move):
        # a resume's staging buffer is zeroed first, so a read before its
        # copy lands sees zeros, not memory a like run left behind
        def call(self, dst, src):
            if dst.is_cuda:
                dst.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            return move(self, dst, src)
        return call

    def change(broken, ref):
        """max |logits - ref's| over the steps (NaN counts as infinite)."""
        return max(float(torch.nan_to_num((a - b).abs(), nan=float("inf"))
                         .max())
                   for a, b in zip(broken["logits"], ref["logits"]))

    def follow_unless(skip):
        def make(follow):
            def call(self, waiter, stream):
                if not skip(waiter):
                    follow(self, waiter, stream)
            return call
        return make

    off = run(generate=True)
    s = off["raw"]
    check(s["tier_kv_parks"] >= 1 and s["tier_kv_resumes"] >= 1,
          f"tiers: {s['tier_kv_parks']} parks, {s['tier_kv_resumes']} "
          f"resumes")
    check(off["park"]["n"] == s["tier_kv_parks"]
          and off["resume"]["n"] == s["tier_kv_resumes"],
          "tiers: copies do not match the parks and resumes")
    check(sum(off["park"]["bytes"]) == s["tier_tx_kv_hbm_host_bytes"],
          f"tiers: parked {sum(off['park']['bytes'])} pinned bytes, the "
          f"tier counted {s['tier_tx_kv_hbm_host_bytes']}")
    check(off["slot_bytes"] == s["tier_hbm_expert_bytes"],
          f"tiers: slot buffers {off['slot_bytes']} B, plan "
          f"{s['tier_hbm_expert_bytes']}")
    check(off["pool_bytes"] == 2 * s["tier_hbm_kv_bytes"] + real_block,
          f"tiers: KV pools {off['pool_bytes']} B != 2 x "
          f"{s['tier_hbm_kv_bytes']} + {real_block}")
    on = run(overlap=True)
    same(on, off, "overlap on vs off")
    replay = run(resume_from_host=False)
    check(replay["tokens"] == off["tokens"], "tiers: replay tokens differ")
    check(replay["raw"]["tier_kv_parks"] == 0, "tiers: replay parked KV")
    check(len(replay["step_ms"]) > len(off["step_ms"]),
          f"tiers: replay took {len(replay['step_ms'])} steps, resume "
          f"{len(off['step_ms'])}")
    disk = run(host_budget_bytes=store.total_nbytes() // 2)
    d = disk["raw"]
    check(disk["tokens"] == off["tokens"], "tiers: disk-tier tokens differ")
    check(d["tier_expert_disk_fetches"] > 0, "tiers: no disk fetch")
    clock_gap = ((d["sim_time_s"] - d["tier_stall_s"])
                 - (s["sim_time_s"] - s["tier_stall_s"]))
    check(abs(clock_gap) <= 1e-9 * s["sim_time_s"],
          f"tiers: disk run's clock off the stall by {clock_gap} s")
    races = {"sleep_cycles": SLEEP_CYCLES}
    with patched(PagedKVCache, "_move", zero_then_sleep):
        same(run(overlap=True), on, "sleep before park/resume copies")
        with patched(PagedKVCache, "_follow",
                     follow_unless(lambda w: w == compute)):
            broken = run(overlap=True)
        races["resume_without_ready_wait"] = change(broken, on)
    with patched(PagedKVCache, "park_blocks", sleep_first):
        same(run(overlap=True), on, "sleep before park gathers")
        with patched(PagedKVCache, "_follow",
                     follow_unless(lambda w: w != compute)):
            broken = run(overlap=True)
        races["park_without_gather_wait"] = change(broken, on)
    for name, diff in races.items():
        if name != "sleep_cycles":
            check(diff != 0, f"tiers: {name}: the logits did not change")

    def steps(rec):
        return {"steps": len(rec["step_ms"]), "loop_ms": rec["loop_ms"],
                "step_ms_median": statistics.median(rec["step_ms"]),
                "step_ms_max": max(rec["step_ms"])}

    return {
        "card": card, "quant": store.quant, "budget_bytes": budget,
        "plan": {"slots_per_layer": TIER_SLOTS, "kv_blocks": TIER_BLOCKS,
                 "slot_price_bytes": slot_price,
                 "block_price_bytes": block_price,
                 "tier_hbm_expert_bytes": s["tier_hbm_expert_bytes"],
                 "tier_hbm_kv_bytes": s["tier_hbm_kv_bytes"]},
        "real": {"slot_buffer_bytes": off["slot_bytes"],
                 "kv_pool_bytes": off["pool_bytes"],
                 "kv_block_bytes": real_block,
                 "memory_allocated_growth_at_build": off["built_bytes"],
                 "growth_not_slots_or_pool": (off["built_bytes"]
                                              - off["slot_bytes"]
                                              - off["pool_bytes"]),
                 "int8_staging_bytes_first_install": off["staging_bytes"]},
        "parks": {"overlap_off": off["park"], "overlap_on": on["park"]},
        "resumes": {"overlap_off": off["resume"],
                    "overlap_on": on["resume"]},
        "resume": {"overlap_off": steps(off), "overlap_on": steps(on)},
        "replay": steps(replay),
        "disk": {"host_budget_bytes": store.total_nbytes() // 2,
                 "tier_expert_disk_fetches": d["tier_expert_disk_fetches"],
                 "tier_stall_s": d["tier_stall_s"],
                 "sim_time_s": d["sim_time_s"], **steps(disk)},
        "sim_time_s": {"resume": s["sim_time_s"],
                       "replay": replay["raw"]["sim_time_s"]},
        "launches": off["launches"], "races": races,
        "h2d_expert_bytes": sum(off["step_h2d"]),
        "equal": ["tokens_vs_generate", "overlap_on_vs_off",
                  "replay_tokens", "disk_tokens", "step_h2d_bytes",
                  "sleeps_bitwise"],
        "new_tokens": [t[TIER_PROMPT_LEN:] for t in off["tokens"]],
        "seconds": time.perf_counter() - t_phase}


def int8_serving(params, cfg, prompts, ops, server_kw, model, profiler,
                 card):
    """The offload server with ``quant="int8"`` on the fp32 run's model
    and workload: int8 masters and scale rows pinned, no host dequant
    (``ExpertStore.fetch`` is never called) while serving or generating,
    server tokens == ``generate``, each step's bytes == the trace's moved
    experts x the stored bytes of one (checked in ``serve``), every
    resident slot bitwise the host dequant of its expert. On the same
    int8 masters: the run again with overlap on (``overlap_run``), then
    the learned policy and predictor (``learned_serving``), then the
    memory tiers (``tier_serving``). ``profiler()`` gives a profiler for
    a serving loop, or None. Returns the four reports."""
    import torch
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    t0 = time.perf_counter()
    srv = ContinuousOffloadServer(params, cfg, quant="int8", **server_kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    store = srv.engine.store
    stored = [t for k in store.keys() for pair in store.payload(k).values()
              for t in pair]
    check(all(t.is_pinned() for t in stored),
          "int8 masters or scales are not in pinned host memory")
    check({t.dtype for t in stored} == {torch.int8, torch.float32},
          f"int8 store holds {sorted({str(t.dtype) for t in stored})}")
    fetched = []
    fetch = store.fetch
    store.fetch = lambda key: fetched.append(key) or fetch(key)
    prof = profiler()
    rids, launches, step_ms, step_h2d, _, loop_ms = serve(srv, prompts, ops,
                                                          prof)
    off = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches)
    on_rep, on = overlap_run(params, cfg, prompts, ops, server_kw, store, srv,
                             off, profiler())
    learned_rep = learned_serving(params, cfg, prompts, ops, server_kw, store,
                                  model, on)
    tier_rep = tier_serving(params, cfg, ops, store, card)
    check(not fetched, f"int8 serving: ExpertStore.fetch called "
                       f"{len(fetched)} times")
    served = off["tokens"]
    for p, out in zip(prompts, served):
        want = srv.engine.generate(p, NEW_TOKENS)
        check(out == want, f"int8: server {out[PROMPT_LEN:]} != generate "
                           f"{want[PROMPT_LEN:]} for prompt {p}")
    check(not fetched, f"int8 generate: ExpertStore.fetch called "
                       f"{len(fetched)} times")
    store.fetch = fetch
    torch.cuda.synchronize()
    slots = 0
    for c in srv.engine.caches:
        for eid, slot in c.slot_of.items():
            want = store.fetch((c.layer, eid))
            for k, w in want.items():
                check(torch.equal(c.buffers[k][slot].cpu(), w),
                      f"int8: layer {c.layer} expert {eid} {k} slot differs "
                      f"from the host dequant")
            slots += 1
    rep = {"setup_s": setup_s, "expert_master_bytes": store.total_nbytes(),
           "expert_bytes": store.expert_nbytes((0, 0)),
           "steps": len(step_ms), "step_ms": step_ms,
           "h2d_expert_bytes": step_h2d, "launches": launches,
           "loop_ms": loop_ms, "fetch_calls": 0,
           "server_equals_generate": True, "slots_bitwise": slots,
           "new_tokens": [o[PROMPT_LEN:] for o in served]}
    if prof is not None:
        rep["profile"] = device_time_summary(prof, loop_ms, sum(step_h2d))
    del srv, store, stored
    gc.collect()
    return rep, on_rep, learned_rep, tier_rep


def offload_invariants(params, cfg, prompts, store):
    """The offload server's invariants on the card, each against one
    reference run (overlap off, per-token prefill, no fault injector) on
    the first INVARIANT_REQUESTS prompts: overlap on and chunked prefill
    give the same tokens (overlap on: every step's logits bitwise too); a
    null fault plan the same tokens, trace and stats() (plus the
    injector's own counters, all zero). Then the race checks, on a cache
    of RACE_SLOTS slots against an overlap-off run of it: overlap on with
    ``torch.cuda._sleep`` queued on the copy stream before every install
    (a read that skipped a slot's ready event would see the old expert),
    and with it queued on the compute stream before every
    ``ops.moe_ffn`` (a copy that skipped the slot's last-reader event
    would overwrite weights still to be read; a sleep after the launch
    would not delay the read): tokens and every step's logits bitwise the
    reference's. Each race run has a negative control: the same sleeps
    with that event's wait taken out of a copy of ``ExpertCache.reading``
    (ready) or ``ExpertCache._writing`` (last reader) made here, which
    must change the logits, so the check can fail. Servers are built one
    at a time, on the fp32 masters ``store``. Raises on a mismatch."""
    import torch
    from repro_torch.core.expert_cache import ExpertCache
    from repro_torch.core.faults import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    base = dict(cache_slots=4, policy="lfu", prefetch="spec",
                max_batch=INVARIANT_REQUESTS, kv_block_size=16,
                cache_len=PROMPT_LEN + INVARIANT_TOKENS, device="cuda")

    def run(**kw):
        with reusing(store):
            srv = ContinuousOffloadServer(params, cfg, **{**base, **kw})
        rids = [srv.submit(p, max_new=INVARIANT_TOKENS)
                for p in prompts[:INVARIANT_REQUESTS]]
        logits = []
        while srv.pending:
            srv.step()
            logits.append(srv._logits.clone())
        torch.cuda.synchronize()
        out = ([srv.result(r)[PROMPT_LEN:] for r in rids], srv.stats(),
               srv.trace.to_json(), logits,
               max(len(r.activated) for r in srv.trace.steps))
        del srv
        gc.collect()
        return out

    def same_logits(logits, want, name):
        check(len(logits) == len(want) and all(
            torch.equal(a, b) for a, b in zip(logits, want)),
            f"offload invariant {name}: logits differ from overlap off")

    def sleep_first(fn):
        def call(*args, **kw):
            torch.cuda._sleep(SLEEP_CYCLES)
            return fn(*args, **kw)
        return call

    def without_ready_wait(_):
        @contextlib.contextmanager
        def reading(self, slots):
            yield
            for s in slots:
                self._last_read[s].record(torch.cuda.current_stream())
        return reading

    def without_last_reader_wait(_):
        @contextlib.contextmanager
        def writing(self, slot):
            with torch.cuda.stream(self.copy_stream):
                yield
                self._ready[slot].record(self.copy_stream)
        return writing

    t0 = time.perf_counter()
    ref = run()
    for name, kw in (("overlap", dict(overlap=True)),
                     ("prefill_chunk", dict(prefill_chunk=4)),
                     ("null_fault_plan", dict(faults=FaultPlan.null()))):
        toks, stats, trace, logits, _ = run(**kw)
        check(toks == ref[0], f"offload invariant {name}: tokens {toks} != "
                              f"{ref[0]}")
        if name == "overlap":
            same_logits(logits, ref[3], name)
        if name == "null_fault_plan":
            # equal on every key of the reference; the counters an
            # injector adds are all zero (repr: NaN equals NaN)
            shared = {k: repr(v) for k, v in stats.items() if k in ref[1]}
            check(shared == {k: repr(v) for k, v in ref[1].items()},
                  f"null fault plan: stats() {stats} != {ref[1]}")
            extra = {k: v for k, v in stats.items() if k not in ref[1]}
            check(all(v == 0 for v in extra.values()),
                  f"null fault plan: fault counters {extra}")
            check(trace == ref[2], "null fault plan: the trace differs")
    race_ref = run(cache_slots=RACE_SLOTS)
    check(race_ref[4] > RACE_SLOTS, f"race workload: batch unions of at "
                                    f"most {race_ref[4]} experts, no chunks")
    races = {"cache_slots": RACE_SLOTS, "max_union": race_ref[4],
             "sleep_cycles": SLEEP_CYCLES}
    for name, owner, attr, control in (
            ("copy_stream_sleep", ExpertCache, "_copy_in",
             ("reading", without_ready_wait)),
            ("compute_stream_sleep", ops, "moe_ffn",
             ("_writing", without_last_reader_wait))):
        t1 = time.perf_counter()
        with patched(owner, attr, sleep_first):
            toks, _, _, logits, _ = run(overlap=True, cache_slots=RACE_SLOTS)
            seconds = time.perf_counter() - t1
            with patched(ExpertCache, *control):
                _, _, _, broken, _ = run(overlap=True,
                                         cache_slots=RACE_SLOTS)
        check(toks == race_ref[0], f"race check {name}: tokens {toks} != "
                                   f"{race_ref[0]}")
        same_logits(logits, race_ref[3], name)
        diff = max(float((a - b).abs().max())
                   for a, b in zip(broken, race_ref[3]))
        check(diff > 0, f"race check {name}: with the {control[0]} wait "
                        f"taken out the logits did not change")
        races[name] = {"seconds": seconds, "steps": len(logits),
                       "control_without_wait_in": control[0],
                       "control_max_abs_logit_diff": diff}
    return {"offload_invariants": ["overlap", "prefill_chunk",
                                   "null_fault_plan"],
            "race_checks": races, "tokens": ref[0],
            "seconds": time.perf_counter() - t0}


def pairs_times_heads(q, k, v, causal=True, window=0):
    """A flash_attention call's (query, key) pairs scored, times heads."""
    from repro_torch.kernels.flash_attention import visible_pairs
    return q.shape[0] * q.shape[2] * visible_pairs(q.shape[1], k.shape[1],
                                                   causal, window)


PREFILL_SPECS = {   # heaviest prefill calls, copied as they were
    "flash_attention": (   # by (query, key) pairs scored, times heads
        pairs_times_heads,
        lambda q, k, v, **kw: (q.clone(), k.clone(), v.clone(), dict(kw))),
    "ssd_chunk": (lambda dA, xw, *_: xw.numel(),
                  lambda *args: tuple(a.clone() for a in args)),
}


def prefill_run(params, cfg, toks, ops, seen, prof=None, **kw):
    """One ``prefill`` with every launch count reset just before and read
    just after, recording the kernels' heaviest calls into ``seen``.
    Returns (logits, launches, wall ms, profile or None)."""
    import torch
    from repro_torch.models.transformer import prefill
    with recording(ops, seen, PREFILL_SPECS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        logits = prefill(params, cfg, toks, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.stop()
        launches = ops.launch_counts()
    summary = device_time_summary(prof, ms) if prof is not None else None
    return logits, launches, ms, summary


def dryrun_phase(params, cfg, ops, card):
    """Phase 6d: the op counter on the card against the same calls on
    meta copies, its kernel calls against the launch counts, each call
    timed without the counter, then the dry run's CLI on DRY_CASES.
    Returns the ``dryrun`` line's record."""
    import numpy as np
    import torch
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.transformer import (_tree_map, decode_step,
                                                init_decode_state, prefill)
    rng = np.random.default_rng(SEED + 3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (DRY_B, DRY_S))).cuda()
    meta = _tree_map(lambda t: t.to("meta"), params)
    meta_toks = toks.to("meta")
    states = {"cuda": init_decode_state(params, cfg, DRY_B, DRY_CACHE,
                                        device="cuda"),
              "meta": init_decode_state(meta, cfg, DRY_B, DRY_CACHE,
                                        device="meta")}
    calls = {
        "prefill": lambda p, t, st: prefill(p, cfg, t),
        "decode_step": lambda p, t, st: decode_step(p, cfg, st, t[:, :1],
                                                    DRY_S)[0]}
    rec = {"model": cfg.name, "layers": cfg.num_layers, "card": card}
    for name, call in calls.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), OpCost() as on_card:
            call(params, toks, states["cuda"])
        torch.cuda.synchronize()
        counted_ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        peak_rise = torch.cuda.max_memory_allocated() - base
        with torch.no_grad(), OpCost() as on_meta:
            call(meta, meta_toks, states["meta"])
        got, want = on_card.to_dict(), on_meta.to_dict()
        check(got.pop("devices") == ["cuda"] and
              want.pop("devices") == ["meta"],
              f"dry run {name}: devices {sorted(on_card.devices)} and "
              f"{sorted(on_meta.devices)}")
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        check(not diff, f"dry run {name}: card and meta counts differ: "
                        f"{diff}")
        kernel_calls = {k: v["calls"] for k, v in got["kernel_calls"].items()}
        check(kernel_calls == {k: n for k, n in launches.items() if n},
              f"dry run {name}: kernel calls {kernel_calls} != launches "
              f"{launches}")
        times = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(params, toks, states["cuda"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[1]
        rec[name] = dict(got, ms=ms, counted_ms=counted_ms, step_ms=times,
                         launches=launches,
                         tflop_s=got["flops"] / ms / 1e9,
                         tb_s=got["bytes_accessed"] / ms / 1e9,
                         max_memory_allocated_rise=peak_rise)
    del states, meta, meta_toks
    cases = []
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRY_CASES:
            out = Path(tmp) / f"{arch}-{shape}.json"
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", str(out)], cwd=ROOT,
                env=env, capture_output=True, text=True, timeout=600)
            print(r.stdout, end="", flush=True)
            check(r.returncode == 0 and "1 ok, 0 failed" in r.stdout,
                  f"dry run {arch} x {shape}: exit {r.returncode}\n"
                  f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
            (res,) = json.loads(out.read_text())["results"]
            res["wall_s"] = time.perf_counter() - t0
            cases.append(res)
    rec["cases"] = cases
    return rec


def check_launches(launches, want, what):
    """The prefill's counts: ``want`` (kernel -> launches) exactly, and no
    launch of any other kernel."""
    for name, n in launches.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, "
                                      f"expected {want.get(name, 0)}")


def cross_layers(cfg) -> int:
    return sum(cfg.has_cross_attn(i) for i in range(cfg.num_layers))


def whole_layers(cfg) -> int:
    """The layers ``init_params`` holds: the hybrid and vlm families stack
    theirs by period, and keep whole periods only."""
    period = {"hybrid": cfg.attn_every,
              "vlm": cfg.cross_attn_every}.get(cfg.family, 1)
    return cfg.num_layers - cfg.num_layers % period


def prefill_launches(cfg):
    """A prefill's launches, from the layer kinds: flash attention once
    per attention layer and once per cross-attention layer, SSD chunk
    once per SSM layer, over ``whole_layers``."""
    layers = whole_layers(cfg)
    kinds = [cfg.layer_kind(i) for i in range(layers)]
    return {"flash_attention": kinds.count("attn")
            + sum(cfg.has_cross_attn(i) for i in range(layers)),
            "ssd_chunk": kinds.count("ssm")}


def engine_vs_prefill(params, cfg, toks, pre_logits, enc=None, *,
                      routed=True):
    """``ServingEngine(moe_path="dense").generate_batch`` on the prompts
    ``toks`` [B, S] (and ``enc``): its decode_step logits at the last
    prompt position must equal ``pre_logits`` (prefill on the same
    prompts) within PREFILL_TOL (rtol = atol; a bf16 model: within
    BF16_PREFILL_TOL x max |pre_logits|), and its first token the
    prefill's argmax on every row whose top-2 margin exceeds twice the
    tolerance. Its launch counts, reset just before and read just after,
    must be one flash attention per cross-attention layer per decode step
    (Sq = 1; self-attention and SSM decode are plain PyTorch) and nothing
    else, every one of them on the one-query route (``ops.route_counts``;
    ``routed`` False: none of them, a checkout without the route for the
    model's dtype, which ``tools/flash_one_query_check.py`` times). A
    bf16 model's run goes again under ``torch.profiler`` (device activity
    only: its device time by kind, busy and idle share; the profiler
    slows the host, so its wall is not ``engine_s``), with the same
    tokens: the bf16 engines' device time is this script's record, the
    fp32 engines' the tool's. The engine's first flash attention call is
    kept (by reference) in the report's "flash_call", to be held and
    timed."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    B, S = toks.shape
    eng = ServingEngine(params, cfg, cache_len=S + ENGINE_NEW,
                        moe_path="dense", device="cuda")
    last = {}
    step = eng._step

    def step_keeping_last_prompt_logits(state, tokens, pos):
        logits, state = step(state, tokens, pos)
        if pos == S - 1:
            last["logits"] = logits.clone()
        return logits, state

    eng._step = step_keeping_last_prompt_logits
    kept = []
    flash = ops.flash_attention

    def flash_keeping_first_call(q, k, v, **kw):
        if not kept:
            kept.append((q, k, v, dict(kw)))
        return flash(q, k, v, **kw)

    torch.cuda.synchronize()
    with patched(ops, "flash_attention", lambda _: flash_keeping_first_call):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = eng.generate_batch(toks.tolist(), max_new=ENGINE_NEW, enc=enc)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, routes = ops.launch_counts(), ops.route_counts()
    # the engine runs S + ENGINE_NEW steps (its last one's logits unused)
    check_launches(launches,
                   {"flash_attention": cross_layers(cfg) * (S + ENGINE_NEW)},
                   f"{cfg.name} engine")
    check(routes["flash_attention_one_query"]
          == (launches["flash_attention"] if routed else 0),
          f"{cfg.name} engine: {routes} of {launches['flash_attention']} "
          f"flash launches took the one-query route (routed {routed})")
    dec = last["logits"]
    V = cfg.vocab_size
    check(tuple(pre_logits.shape) == (B, V) == tuple(dec.shape),
          f"logits shapes {tuple(pre_logits.shape)}, {tuple(dec.shape)}")
    check(bool(torch.isfinite(pre_logits).all()), "non-finite prefill logits")
    check(all(len(o) == ENGINE_NEW and all(0 <= t < V for t in o)
              for o in outs), f"engine output {outs}")
    err = float((pre_logits - dec).abs().max())
    top_abs = float(pre_logits.abs().max())
    bf16 = cfg.dtype == "bfloat16"
    rtol, atol = ((0.0, BF16_PREFILL_TOL * top_abs) if bf16
                  else (PREFILL_TOL, PREFILL_TOL))
    check(torch.allclose(pre_logits, dec, rtol=rtol, atol=atol),
          f"{cfg.name}: prefill vs decode_step logits differ by {err:.3e} "
          f"(max |prefill| {top_abs:.3e})")
    top = torch.topk(pre_logits, 2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > 2 * (atol + rtol * top[:, 0].abs())
    first = torch.tensor([o[0] for o in outs], device=pre_logits.device)
    same = first == pre_logits.argmax(dim=-1)
    check(bool(same[sure].all()), f"{cfg.name}: engine first tokens "
          f"{first.tolist()} != prefill argmax on rows with a clear margin")
    rep = {"prefill_vs_decode_max_abs_err": err,
           "max_abs_prefill_logit": top_abs, "rtol": rtol, "atol": atol,
           "first_token_rows_checked": int(sure.sum()),
           "engine_tokens": outs, "engine_s": seconds,
           "engine_launches": launches, "engine_routes": routes,
           "flash_call": kept[0] if kept else None}
    if bf16:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.start()
        again = eng.generate_batch(toks.tolist(), max_new=ENGINE_NEW, enc=enc)
        torch.cuda.synchronize()
        prof.stop()
        rep["profiled_engine"] = device_time_summary(
            prof, (time.perf_counter() - t0) * 1e3)
        check(again == outs, f"{cfg.name} engine: a second run's tokens "
                             f"{again} != {outs}")
    return rep


def prefill_phase(params, cfg, ops, seen, profile, *, enc=None,
                  engine_s=ENGINE_S, prefill_s=PREFILL_S, engine_call=None,
                  routed=True):
    """Drive ``prefill`` and ``ServingEngine`` for one model (``enc``:
    the cross layers' encoder states or patch embeddings): the
    ``engine_s``-token comparison (``moe_path="dense"``), then two
    PREFILL_B x ``prefill_s`` prefills through ``moe_path="auto"``
    (counted and timed; the second is warm) and, with ``profile``, a
    third under the profiler. Every prefill launches what
    ``prefill_launches`` says and nothing else. The engine's first flash
    attention call, where it made one, goes into ``engine_call``
    ("flash_attention": (q, k, v, kw)); ``routed``: as
    ``engine_vs_prefill``. Returns (launches summed over the counted
    runs, report)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    want = prefill_launches(cfg)
    total = {name: 0 for name in ops.LAUNCHES}
    rep = {"model": cfg.name, "layers": cfg.num_layers}

    def counted(toks, what, **kw):
        logits, launches, ms, _ = prefill_run(params, cfg, toks, ops, seen,
                                              enc=enc, **kw)
        check_launches(launches, want, what)
        for name, n in launches.items():
            total[name] += n
        return logits, launches, ms

    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, engine_s))).cuda()
    logits, launches, ms = counted(toks, f"{cfg.name} prefill "
                                         f"{PREFILL_B}x{engine_s}",
                                   moe_path="dense")
    rep[f"prefill_{PREFILL_B}x{engine_s}"] = {
        "moe_path": "dense", "launches": launches, "ms": ms}
    rep["engine"] = engine_vs_prefill(params, cfg, toks, logits, enc,
                                      routed=routed)
    call = rep["engine"].pop("flash_call")
    if call is not None and engine_call is not None:
        engine_call["flash_attention"] = call

    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, prefill_s))).cuda()
    for run in ("cold", "warm"):
        logits, launches, ms = counted(
            toks, f"{cfg.name} prefill {PREFILL_B}x{prefill_s}")
        check(tuple(logits.shape) == (PREFILL_B, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name}: prefill logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
        rep[f"prefill_{PREFILL_B}x{prefill_s}_{run}"] = {
            "launches": launches, "ms": ms}
    if profile:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        rep["profile"] = prefill_run(params, cfg, toks, ops, {}, prof,
                                     enc=enc)[3]
    return total, rep


def mem_available() -> int:
    """The host's MemAvailable (``/proc/meminfo``), in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def track_router_margins(engine, seen):
    """Make each MoE layer call of ``engine`` append to ``seen`` the
    smallest gap between the k-th and (k+1)-th router logit of its active
    rows: how close the run's routing came to a tie."""
    import torch
    from repro_torch.models.layers import rms_norm
    cfg = engine.cfg
    k = cfg.num_experts_per_tok
    moe = engine._moe_offloaded

    def call(p_l, layer, h, *rest):
        x = rms_norm(h, p_l["ln2"], cfg.norm_eps)
        top = torch.topk((x.float() @ p_l["moe"]["router"])[:, 0], k + 1,
                         dim=-1).values.cpu()
        gaps = (top[:, k - 1] - top[:, k])[torch.tensor(rest[-1])]
        seen.append(float(gaps.min()))
        return moe(p_l, layer, h, *rest)

    engine._moe_offloaded = call


def deepseek_phase(ops, card, hold_and_time, profile, mesh):
    """DeepSeek-V2 at its full published widths (d_model 5120, 128 heads
    of hd 128, MLA with kv_lora_rank 512 and a 64-wide rope key, 160
    routed experts of d_ff 1536 top-6 beside the shared SwiGLU of width
    3072, vocab 102400), depth cut to DS_LAYERS of 60, fp32, random
    weights drawn on the card from the seeded generator; the fp32 expert
    masters pinned in host memory.

    Offload serving: the staggered workload (4 requests, PROMPT_LEN-token
    prompts, NEW_TOKENS greedy tokens) through ``ContinuousOffloadServer``
    with DS_SLOTS slots a layer, LFU, speculative prefetch, max_batch 4
    and paged latent KV in 16-token blocks (MLA's paged decode is plain
    PyTorch, as in the JAX package: ``paged_attention`` must not launch).
    Every step: bytes == the trace's moved experts x 94,371,840, and
    ``moe_ffn`` launched at least once for each layer. Finite logits of
    shape [4, vocab], overlap on == off (``overlap_run``), server tokens
    == ``generate`` (dense multipos MLA decode). Then ``prefill_phase``:
    flash attention at q/k width 192 and v width 128 once a layer, and
    the prefill's logits against the absorbed decode's. Both kernels are
    held against their plain versions at this model's heaviest calls
    (``hold_and_time``, entries marked with the model). ``profile``
    traces the overlap-off serving loop and one prefill. The same
    serving workload then runs under ``mesh`` (``mla_mesh_serving``) on
    the same masters. Last, on the same params, the distributed phase's
    MLA decode on ``mesh`` (``mla_decode_check``). Returns the serving,
    prefill and MLA decode reports."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.offload_serving import ContinuousOffloadServer

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=DS_LAYERS, dtype="float32")
    expert_bytes = 3 * cfg.d_model * cfg.expert_d_ff * 4
    print(json.dumps({"deepseek_memory": {
        "mem_available_bytes": mem_available(),
        "pinned_expert_bytes": cfg.num_layers * cfg.num_experts
        * expert_bytes}}), flush=True)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    server_kw = dict(cache_slots=DS_SLOTS, policy="lfu", prefetch="spec",
                     max_batch=4, kv_block_size=16,
                     cache_len=PROMPT_LEN + NEW_TOKENS, device="cuda")
    srv = ContinuousOffloadServer(params, cfg, **server_kw)
    torch.cuda.synchronize()
    store = srv.engine.store
    check(store.expert_nbytes((0, 0)) == expert_bytes,
          f"stored expert bytes {store.expert_nbytes((0, 0))}")
    check(all(v.is_pinned() and s is None for k in store.keys()
              for v, s in store.payload(k).values()),
          "deepseek: expert masters are not in pinned host memory")
    pool = srv.paged.state["layers"][0]
    check({k: tuple(v.shape[2:]) for k, v in pool.items()}
          == {"latent": (cfg.kv_lora_rank,), "k_rope": (cfg.qk_rope_dim,)},
          f"deepseek: KV pool {[(k, v.shape) for k, v in pool.items()]}")
    setup = {"setup_s": time.perf_counter() - t0,
             "expert_master_bytes": store.total_nbytes(),
             "expert_slot_bytes": sum(c.device_nbytes()
                                      for c in srv.engine.caches),
             "device_bytes_allocated": torch.cuda.memory_allocated(),
             "mem_available_bytes": mem_available()}
    print(json.dumps({"deepseek_setup": setup}), flush=True)

    rng = np.random.default_rng(SEED + 2)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in SUBMIT_AT_STEP]
    margins, per_step = [], []
    track_router_margins(srv.engine, margins)
    prof = None
    if profile:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
    rids, launches, step_ms, step_h2d, calls, loop_ms = serve(
        srv, prompts, ops, prof, per_step=per_step)
    moe_per_step, done = [], 0
    for i, (counts, rows) in enumerate(per_step):
        moe_per_step.append(counts["moe_ffn"] - done)
        done = counts["moe_ffn"]
        check(rows == cfg.num_layers and moe_per_step[-1] >= rows,
              f"deepseek step {i}: {moe_per_step[-1]} moe_ffn launches for "
              f"{rows} trace rows")
    check(launches["paged_attention"] == 0,
          f"deepseek: paged_attention launched {launches['paged_attention']}"
          f" times (MLA's paged decode has no kernel)")
    off = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches,
                     kernels=("moe_ffn",))
    logits = srv._logits
    check(tuple(logits.shape) == (4, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"deepseek: logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    on_rep, _ = overlap_run(params, cfg, prompts, ops, server_kw, store, srv,
                            off, kernels=("moe_ffn",))
    check(on_rep["launches"]["paged_attention"] == 0,
          "deepseek overlap: paged_attention launched")
    t0 = time.perf_counter()
    for p, out in zip(prompts, off["tokens"]):
        want = srv.engine.generate(p, NEW_TOKENS)
        check(out == want, f"deepseek: server {out[PROMPT_LEN:]} != "
                           f"generate {want[PROMPT_LEN:]} for prompt {p}")
    generate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_rep = mla_mesh_serving(params, cfg, prompts, ops, server_kw, store,
                                mesh, off)
    mesh_rep["s"] = time.perf_counter() - t0
    hold_and_time(calls, launches, model=cfg.name)
    rep = {"model": cfg.name, "layers": cfg.num_layers,
           "slots_per_layer": DS_SLOTS, "requests": len(prompts),
           "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
           "steps": len(step_ms), "overlap": on_rep["overlap"],
           "step_ms_median": on_rep["step_ms_median"],
           "step_ms_max": on_rep["step_ms_max"],
           "loop_ms": on_rep["loop_ms"],
           "h2d_expert_bytes": sum(step_h2d), "expert_bytes": expert_bytes,
           "experts_moved": sum(step_h2d) // expert_bytes,
           "h2d_equals_trace": True, "launches": launches,
           "moe_ffn_launches_per_step": moe_per_step,
           "min_router_margin": min(margins), "counts": off["counts"],
           "sim_time_s": off["clock"]["sim_time_s"],
           "overlap_equal": on_rep["equal"],
           "server_equals_generate": True, "generate_s": generate_s,
           "new_tokens_out": [o[PROMPT_LEN:] for o in off["tokens"]],
           "mesh": mesh_rep, "setup": setup, "card": card}
    if prof is not None:
        rep["profile"] = device_time_summary(prof, loop_ms, sum(step_h2d))
    del srv, store, calls, pool, logits, prof
    gc.collect()
    torch.cuda.empty_cache()

    seen = {}
    flash, prefill_rep = prefill_phase(params, cfg, ops, seen, profile)
    hold_and_time({"flash_attention": seen["flash_attention"][1]},
                  {"flash_attention": flash["flash_attention"]},
                  model=cfg.name)
    prefill_rep["card"] = card
    t0 = time.perf_counter()
    mla = mla_decode_check(params, cfg, mesh)
    mla["s"] = time.perf_counter() - t0
    del params, seen
    gc.collect()
    torch.cuda.empty_cache()
    return rep, prefill_rep, mla


def open_mesh():
    """One NCCL process group of world size 1 (``tcp://127.0.0.1`` on a
    port free at run time) and its (1, 1) ("data", "model") mesh on the
    card."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"), "cuda")


def mesh_rules(arch, mesh):
    """The published arch's rules (its full depth: the depth cut would
    make ``sharding_rules`` take Mixtral for a tiny, replicated model)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import sharding_rules
    return sharding_rules(get_config(arch), mesh)


def ep_check(params, cfg, mesh):
    """(a) One MoE layer of Mixtral-8x7B at its published widths, fp32,
    on EP_B x EP_S seeded tokens: ``moe_apply`` under the mesh takes the
    expert-parallel path (``moe_ep_shardmap``, counted), whose two
    ``all_to_all_single`` exchanges are timed by CUDA events; its output
    and aux must equal ``moe_capacity`` without a mesh bitwise (one rank:
    the same dispatch, capacity and products; the exchanges move the
    buffers unchanged). Both are timed (``device_ms``)."""
    import torch
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import _layer
    rules = mesh_rules("mixtral-8x7b", mesh)
    check(rules["experts_mode"] == "ep", f"rules {rules}")
    p = _layer(params["layers"], 0)["moe"]
    local = shd.shard_params(p, mesh, rules)
    x = torch.randn((EP_B, EP_S, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED + 7))
    want, want_aux = moe_lib.moe_capacity(p, cfg, x)
    ep_calls, exchanges = [], []

    def counted(ep):
        def call(*a, **kw):
            ep_calls.append(1)
            return ep(*a, **kw)
        return call

    def timed(exchange):
        def call(t, axis):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = exchange(t, axis)
            ev[1].record()
            exchanges.append((ev, t.numel() * t.element_size()))
            return out
        return call

    with shd.sharding_ctx(mesh, rules), \
            patched(moe_lib, "moe_ep_shardmap", counted), \
            patched(moe_lib, "_exchange", timed):
        got, aux = moe_lib.moe_apply(local, cfg, x)
    torch.cuda.synchronize()
    check(len(ep_calls) == 1 and len(exchanges) == 2,
          f"EP: moe_ep_shardmap called {len(ep_calls)} times, "
          f"{len(exchanges)} exchanges")
    err = float((got - want).abs().max())
    check(torch.equal(got, want) and torch.equal(aux, want_aux),
          f"EP != moe_capacity at one rank: max |diff| {err}, aux "
          f"{float(aux)} vs {float(want_aux)}")

    def ep():
        with shd.sharding_ctx(mesh, rules):
            moe_lib.moe_apply(local, cfg, x)
    return {"tokens": EP_B * EP_S, "experts": cfg.num_experts,
            "top_k": cfg.num_experts_per_tok, "bitwise": True,
            "max_abs_diff": err,
            "ep_ms": device_ms(ep, 3, graph=False),
            "capacity_ms": device_ms(lambda: moe_lib.moe_capacity(p, cfg, x),
                                     3, graph=False),
            "exchange_ms": [ev[0].elapsed_time(ev[1])
                            for ev, _ in exchanges],
            "exchange_bytes": [n for _, n in exchanges]}


def mesh_prefill(params, cfg, arch, mesh, ops, seen, want, what, *,
                 seq=PREFILL_S, enc=None, also=()):
    """``prefill`` of PREFILL_B x ``seq`` seeded tokens (and ``enc``, the
    whole encoder states or patch embeddings) without a mesh (timed),
    then under the mesh with ``arch``'s published rules and the params
    cut by ``shard_params``: counted (``want``: kernel -> launches, and
    nothing else; the heaviest calls into ``seen``, each context of
    ``also`` entered around the run) and timed, its logits
    bitwise the unsharded ones (one rank: the same products; the
    collectives leave a single rank's values as they are); then both
    again in TURNS, warm. Returns the report."""
    import numpy as np
    import torch
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import prefill
    rules = mesh_rules(arch, mesh)
    local = shd.shard_params(params, mesh, rules)
    toks = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (PREFILL_B, seq))).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = prefill(params, cfg, toks, enc=enc)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with shd.sharding_ctx(mesh, rules), contextlib.ExitStack() as stack:
        for ctx in also:
            stack.enter_context(ctx)
        logits, launches, ms, _ = prefill_run(local, cfg, toks, ops, seen,
                                              enc=enc)
    check_launches(launches, want, what)
    err = float((logits - plain).abs().max())
    check(torch.equal(logits, plain),
          f"{what} != prefill at one rank: max |diff| {err}")
    turns = {"plain": [], "mesh": []}
    for turn in TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == "mesh":
            with shd.sharding_ctx(mesh, rules):
                prefill(local, cfg, toks, enc=enc)
        else:
            prefill(params, cfg, toks, enc=enc)
        torch.cuda.synchronize()
        turns[turn].append((time.perf_counter() - t0) * 1e3)
    return {"tokens": [PREFILL_B, seq], "layers": cfg.num_layers,
            "launches": launches, "bitwise": True, "max_abs_diff": err,
            "mesh_ms": ms, "plain_ms": plain_ms, "turns_ms": turns}


def tp_prefill_check(params, cfg, mesh, ops, seen):
    """(b) Mixtral-8x7B (``cfg``'s layers) under the mesh: ``prefill`` of
    PREFILL_B x PREFILL_S seeded tokens through the tensor-parallel path
    (the rank's heads, one all-reduce after ``wo`` and after each FFN,
    the embedding and the logits gathered; the MoE takes EP), counted
    (flash attention once a layer, nothing else) and timed, against
    ``prefill`` without a mesh, bitwise (``mesh_prefill``)."""
    return mesh_prefill(params, cfg, "mixtral-8x7b", mesh, ops, seen,
                        {"flash_attention": cfg.num_layers},
                        "tensor-parallel prefill")


def kept_logits(engine, out):
    """Each decode step's logits of ``engine`` (a clone) appended to
    ``out`` inside the block."""
    def make(decode_tokens):
        def call(*args, **kw):
            logits, state = decode_tokens(*args, **kw)
            out.append(logits.clone())
            return logits, state
        return call
    return patched(engine, "decode_tokens", make)


def mesh_served(params, cfg, prompts, ops, server_kw, store, where, mesh,
                rules, **kw):
    """One serving run of the staggered workload (``serve``) on the pinned
    masters ``store``, the server built and run inside the mesh under
    ``rules`` (``where`` "mesh") or without one ("plain"), with
    ``server_kw`` updated by ``kw``: ``served_run``'s record (tokens,
    trace rows, stats, clock, per-step bytes, step times, launches) plus
    every step's logits, the recorded kernel calls, the collectives by
    kind (``counting_collectives``), all of ``stats()`` and its rank's KV
    pool's layer-0 shapes."""
    from repro_torch.models import sharding as shd
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    counts, logits = {}, []
    with contextlib.ExitStack() as stack:
        if where == "mesh":
            stack.enter_context(shd.sharding_ctx(mesh, rules))
        with reusing(store):
            srv = ContinuousOffloadServer(params, cfg, **{**server_kw, **kw})
        stack.enter_context(kept_logits(srv.engine, logits))
        stack.enter_context(counting_collectives(counts))
        rids, launches, step_ms, step_h2d, calls, loop_ms = serve(
            srv, prompts, ops)
    rec = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches,
                     kernels=("moe_ffn",))
    rec.update(where=where, logits=logits, calls=calls, collectives=counts,
               all_stats={k: repr(v) for k, v in srv.stats().items()},
               pool=[tuple(v.shape) for v in
                     srv.paged.state["layers"][0].values()])
    del srv
    gc.collect()
    return rec


def same_serving(got, want, what, logits=True):
    """A mesh run's record against a plain one's: tokens, functional
    trace rows, all of ``stats()`` (the clock too), per-step H2D bytes
    and (``logits``) every step's logits bitwise."""
    import torch
    for key in ("tokens", "rows", "all_stats", "step_h2d"):
        check(got[key] == want[key], f"{what}: {key} differ from plain")
    if logits:
        check(len(got["logits"]) == len(want["logits"]) and all(
            torch.equal(a, b) for a, b in zip(got["logits"],
                                              want["logits"])),
              f"{what}: a step's logits differ from plain")


def turn_summary(rec):
    """A serving record's step count, median and max step ms, loop ms."""
    import numpy as np
    return {"where": rec["where"], "steps": len(rec["step_ms"]),
            "step_ms_median": float(np.median(rec["step_ms"])),
            "step_ms_max": max(rec["step_ms"]), "loop_ms": rec["loop_ms"]}


def offload_mesh_check(params, cfg, prompts, store, mesh, ops, server_kw,
                       hold_and_time, card):
    """(i) Mixtral-8x7B offload serving under the mesh (phase 4's
    workload on its pinned masters ``store``: 4 staggered requests,
    LFU with 4 slots, speculative prefetch, paged KV in 16-token blocks)
    with the published rules: ``ContinuousOffloadServer`` built and run
    inside ``sharding_ctx`` from the whole params (attention on the
    rank's heads and KV-head pool, the experts whole), in TURNS against
    the plain server: every mesh run's tokens, trace rows, ``stats()``
    (the simulated clock too), per-step H2D bytes and every step's
    logits bitwise the first plain run's; ``paged_attention`` launched
    once a layer a step and ``moe_ffn`` as often as plain; the first mesh
    run's kernel calls held and timed (``kernels`` entries of their own).
    Then the same with 4-token prefill chunks, plain and mesh. Returns
    the report: step times by turn, collectives a step by kind."""
    rules = mesh_rules("mixtral-8x7b", mesh)
    L = cfg.num_layers
    runs = []
    for turn in TURNS:
        runs.append(mesh_served(params, cfg, prompts, ops, server_kw, store,
                                turn, mesh, rules))
        rec = runs[-1]
        steps = len(rec["step_ms"])
        check(rec["launches"]["paged_attention"] == steps * L,
              f"offload {turn}: paged_attention launched "
              f"{rec['launches']['paged_attention']} times in {steps} steps "
              f"of {L} layers")
        if turn == "mesh":
            same_serving(rec, runs[0], "offload serving under the mesh")
            check(rec["launches"] == runs[0]["launches"],
                  f"offload under the mesh: launches {rec['launches']} != "
                  f"plain {runs[0]['launches']}")
    mesh_run = next(r for r in runs if r["where"] == "mesh")
    hold_and_time(mesh_run["calls"], mesh_run["launches"],
                  model=f"{cfg.name} offload server (1x1 mesh)")
    chunked = [mesh_served(params, cfg, prompts, ops, server_kw, store, w,
                           mesh, rules, prefill_chunk=4)
               for w in ("plain", "mesh")]
    same_serving(chunked[1], chunked[0],
                 "chunked offload serving under the mesh")
    for rec in chunked:
        steps = len(rec["step_ms"])
        check(rec["launches"]["paged_attention"] == steps * L,
              f"chunked {rec['where']}: paged_attention "
              f"{rec['launches']['paged_attention']} in {steps} steps")
    steps = len(mesh_run["step_ms"])
    return {"model": cfg.name, "layers": L, "requests": len(prompts),
            "rules": {k: rules[k] for k in ("model", "shard_kv",
                                            "experts_mode")},
            "pool_layer0": {"plain": runs[0]["pool"],
                            "mesh": mesh_run["pool"]},
            "turns": [turn_summary(r) for r in runs],
            "collectives": mesh_run["collectives"],
            "collectives_per_step": {k: v / steps for k, v in
                                     mesh_run["collectives"].items()},
            "plain_collectives": runs[0]["collectives"],
            "launches": mesh_run["launches"],
            "equal": ["tokens", "rows", "stats", "sim_time", "step_h2d",
                      "logits bitwise"],
            "sim_time_s": mesh_run["clock"]["sim_time_s"],
            "chunked": {"turns": [turn_summary(r) for r in chunked],
                        "launches": chunked[1]["launches"],
                        "collectives": chunked[1]["collectives"],
                        "equal": True},
            "card": card}


def mla_mesh_serving(params, cfg, prompts, ops, server_kw, store, mesh,
                     off):
    """DeepSeek-V2's paged MLA server under the mesh (its published
    rules: the latent pool whole, the rank's heads, one all-reduce after
    ``wo``; the experts whole) on the plain run's pinned masters: tokens
    (and trace rows, ``stats()`` off the clock keys) equal the plain
    server's record ``off``; ``paged_attention`` never launched."""
    rules = mesh_rules("deepseek-v2-236b", mesh)
    rec = mesh_served(params, cfg, prompts, ops, server_kw, store, "mesh",
                      mesh, rules)
    for key in ("tokens", "rows", "stats"):
        check(rec[key] == off[key],
              f"deepseek under the mesh: {key} differ from plain")
    check(rec["launches"]["paged_attention"] == 0,
          "deepseek under the mesh: paged_attention launched")
    steps = len(rec["step_ms"])
    return {"tokens_equal": True, "rows_equal": True, "stats_equal": True,
            "mesh": turn_summary(rec),
            "plain": turn_summary(dict(off, where="plain")),
            "pool_layer0": rec["pool"], "launches": rec["launches"],
            "collectives_per_step": {k: v / steps for k, v in
                                     rec["collectives"].items()}}


def tier_mesh_run(params, cfg, store, where, mesh, rules, ops):
    """One run of phase 4d's tiered workload (``tier_plan``, overlap off)
    on the pinned masters ``store``, the server built and run inside the
    mesh under ``rules`` (``where`` "mesh") or without one ("plain"):
    tokens, every step's logits, the trace rows with ``miss_tiers``, the
    tier events, all of ``stats()`` (the clock too), per-step H2D bytes
    (each checked against the trace's moved experts), each park's priced
    bytes and pinned snapshot, the park and resume copies' times, the
    launches, the recorded kernel calls, the collectives by kind, step
    times and the rank's pool's layer-0 shapes."""
    import torch
    from repro_torch.models import sharding as shd
    from repro_torch.serving.offload_serving import ContinuousOffloadServer
    base, _, prompts = tier_plan(cfg, store.quant)
    seen, counts, moves, parks = {}, {}, [], []
    step_ms, step_h2d, logits = [], [], []
    expert_bytes = store.expert_nbytes((0, 0))
    with contextlib.ExitStack() as stack:
        if where == "mesh":
            stack.enter_context(shd.sharding_ctx(mesh, rules))
        with reusing(store):
            srv = ContinuousOffloadServer(params, cfg, **base)
        check(srv.engine.caches[0].n_slots == TIER_SLOTS
              and srv.paged.num_blocks == TIER_BLOCKS,
              f"tiers {where}: the plan gave {srv.engine.caches[0].n_slots} "
              f"slots and {srv.paged.num_blocks} blocks")
        park = srv.tiers.park_kv

        def parked(rid, arrays, nbytes, *args, **kw):
            parks.append((nbytes, arrays.flat))
            return park(rid, arrays, nbytes, *args, **kw)

        srv.tiers.park_kv = parked
        rids = [srv.submit(p, max_new=TIER_TOKENS) for p in prompts]
        stack.enter_context(recording(ops, seen, SERVING_SPECS))
        stack.enter_context(counting_collectives(counts))
        stack.enter_context(timed_moves(moves))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t_loop = time.perf_counter()
        while srv.pending:
            h2d = sum(c.bytes_transferred for c in srv.engine.caches)
            rows = len(srv.trace.steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(srv._logits.clone())
            step_h2d.append(sum(c.bytes_transferred
                                for c in srv.engine.caches) - h2d)
            moved = sum(len(r.misses) + len(r.prefetched)
                        for r in srv.trace.steps[rows:])
            check(step_h2d[-1] == moved * expert_bytes,
                  f"tiers {where}: step {len(step_ms)}: {step_h2d[-1]} H2D "
                  f"bytes, the trace moved {moved} experts")
        loop_ms = (time.perf_counter() - t_loop) * 1e3
        launches = ops.launch_counts()
    torch.cuda.synchronize()
    stats = srv.stats()
    rec = {"where": where, "tokens": [srv.result(r) for r in rids],
           "logits": logits,
           "rows": [tuple(getattr(r, f) for f in FUNCTIONAL
                          + ("miss_tiers",)) for r in srv.trace.steps],
           "events": [dataclasses.astuple(e) for e in srv.trace.tier_events],
           "all_stats": {k: repr(v) for k, v in stats.items()},
           "raw": stats, "step_h2d": step_h2d, "step_ms": step_ms,
           "loop_ms": loop_ms, "launches": launches,
           "park_bytes": [n for n, _ in parks],
           "snapshots": [flat for _, flat in parks],
           "calls": {k: v[1] for k, v in seen.items()},
           "collectives": counts, **move_times(moves),
           "pool": [tuple(v.shape) for v in
                    srv.paged.state["layers"][0].values()]}
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tier_mesh_check(params, cfg, store, mesh, ops, hold_and_time, card):
    """(j) Memory tiers under the mesh: phase 4d's tiered workload
    (``tier_plan``: one HBM budget split into 4 slots a layer and 4 KV
    blocks of 16, 3 requests of 24 + 16 tokens, 4-token prefill chunks,
    the pool overcommitted so that KV is parked in pinned host memory and
    resumed) on Mixtral's pinned masters ``store``, the tiered server
    built and run inside the mesh with the published rules, in TURNS
    against the plain tiered server (``tier_mesh_run``). Every mesh run
    bitwise the first plain run, or equal where a thing is a count:
    tokens, every step's logits, trace rows with ``miss_tiers``, tier
    events, all of ``stats()`` with the clock, per-step H2D bytes, each
    park's snapshot and the arbiter's bytes for it;
    ``paged_attention`` once a layer a step and ``moe_ffn`` as often as
    plain; the collectives a step by kind: one all-reduce a layer (after
    ``wo``) and two all-gathers (the embedding, the logits), as (i)'s
    server; none in the plain runs. The first mesh run's kernel calls are
    held and timed (``kernels`` entries of their own). Returns the report:
    step ms and park / resume copy ms by turn, the phase's seconds."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    rules = mesh_rules("mixtral-8x7b", mesh)
    L = cfg.num_layers
    runs = []
    for turn in TURNS:
        runs.append(tier_mesh_run(params, cfg, store, turn, mesh, rules,
                                  ops))
        rec, plain = runs[-1], runs[0]
        if turn != "mesh" or len(runs) > 2:
            # the calls keep the run's slot buffers (GBs) by reference:
            # only the first mesh run's are held and timed
            rec.pop("calls")
        steps = len(rec["step_ms"])
        check(rec["launches"]["paged_attention"] == steps * L,
              f"tiers {turn}: paged_attention launched "
              f"{rec['launches']['paged_attention']} times in {steps} steps "
              f"of {L} layers")
        check(rec["launches"]["moe_ffn"] > 0, f"tiers {turn}: no moe_ffn")
        want = ({"all-reduce": L * steps, "all-gather": 2 * steps}
                if turn == "mesh" else {})
        check(rec["collectives"] == want,
              f"tiers {turn}: collectives {rec['collectives']}, expected "
              f"{want}")
        s = rec["raw"]
        check(s["tier_kv_parks"] >= 1 and s["tier_kv_resumes"] >= 1
              and rec["park"]["n"] == s["tier_kv_parks"]
              and rec["resume"]["n"] == s["tier_kv_resumes"],
              f"tiers {turn}: {s['tier_kv_parks']} parks, "
              f"{s['tier_kv_resumes']} resumes, copies {rec['park']['n']} / "
              f"{rec['resume']['n']}")
        if turn == "mesh":
            for key in ("tokens", "rows", "events", "all_stats", "step_h2d",
                        "park_bytes", "launches"):
                check(rec[key] == plain[key],
                      f"tiers under the mesh: {key} differ from plain")
            check(len(rec["logits"]) == len(plain["logits"]) and all(
                torch.equal(a, b) for a, b in zip(rec["logits"],
                                                  plain["logits"])),
                  "tiers under the mesh: a step's logits differ from plain")
            check(len(rec["snapshots"]) == len(plain["snapshots"]) and all(
                torch.equal(a, b) for a, b in zip(rec["snapshots"],
                                                  plain["snapshots"])),
                  "tiers under the mesh: a parked snapshot differs from "
                  "plain")
            check(rec["park"]["bytes"] == plain["park"]["bytes"],
                  "tiers under the mesh: parked host bytes differ")
    mesh_run = next(r for r in runs if r["where"] == "mesh")
    hold_and_time(mesh_run["calls"], mesh_run["launches"],
                  model=f"{cfg.name} tiered server (1x1 mesh)")
    steps = len(mesh_run["step_ms"])
    return {"model": cfg.name, "layers": L, "quant": store.quant,
            "requests": TIER_REQUESTS, "slots_per_layer": TIER_SLOTS,
            "kv_blocks": TIER_BLOCKS,
            "rules": {k: rules[k] for k in ("batch", "model", "shard_kv")},
            "pool_layer0": {"plain": runs[0]["pool"],
                            "mesh": mesh_run["pool"]},
            "turns": [dict(turn_summary(r), park_ms=r["park"]["ms"],
                           resume_ms=r["resume"]["ms"]) for r in runs],
            "parks": mesh_run["raw"]["tier_kv_parks"],
            "resumes": mesh_run["raw"]["tier_kv_resumes"],
            "park_bytes_priced": mesh_run["park_bytes"],
            "park_bytes_host": mesh_run["park"]["bytes"],
            "collectives": mesh_run["collectives"],
            "collectives_per_step": {k: v / steps for k, v in
                                     mesh_run["collectives"].items()},
            "launches": mesh_run["launches"],
            "equal": ["tokens", "logits bitwise", "rows", "tier events",
                      "stats with the clock", "step_h2d", "park snapshots",
                      "park bytes"],
            "sim_time_s": mesh_run["raw"]["sim_time_s"],
            "step_ms_median_by_turn": [float(np.median(r["step_ms"]))
                                       for r in runs],
            "seconds": time.perf_counter() - t_phase, "card": card}


def greedy_decode(params, cfg, state, first, steps):
    """``steps`` greedy ``decode_step``s from the tokens ``first`` [B, 1]
    under whatever mesh is active: (tokens [B, steps], logits [steps, B,
    V], the last state, host ms a step)."""
    import torch
    from repro_torch.models.transformer import decode_step
    tok, toks, logits = first, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pos in range(steps):
        lg, state = decode_step(params, cfg, state, tok, pos)
        tok = lg.argmax(dim=-1, keepdim=True)
        toks.append(tok)
        logits.append(lg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return torch.cat(toks, 1), torch.stack(logits), state, ms


def counted_collectives(calls):
    """Patches that append the name of every ``psum`` / ``pmax`` /
    ``all_gather`` of ``sharding`` to ``calls``."""
    from repro_torch.models import sharding as shd

    def counting(fn):
        def call(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return call

    stack = contextlib.ExitStack()
    for name in ("psum", "pmax", "all_gather"):
        stack.enter_context(patched(shd, name, counting))
    return stack


def mla_decode_check(params, cfg, mesh):
    """(c) DeepSeek-V2 at its published widths (``cfg``'s layers): MLA_B
    rows, MLA_STEPS greedy ``decode_step``s from seeded first tokens,
    once with the unsharded caches and once under the mesh with the
    latent and rope-key caches cut by ``shard_decode_state``
    (sequence-sharded: the rank's block is the whole cache at one rank,
    and the softmax goes through the cross-rank combine). Tokens equal,
    logits within MLA_TOL x max. Then one more step under the mesh counts
    its collectives, and one ``psum`` of a [MLA_B, d] residual is timed
    alone."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import shard_decode_state
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import decode_step, init_decode_state
    rules = mesh_rules("deepseek-v2-236b", mesh)
    check(rules.get("mla_seq_shard", True), f"rules {rules}")
    local = shd.shard_params(params, mesh, rules)
    first = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
        0, cfg.vocab_size, (MLA_B, 1))).cuda()

    want_toks, want, _, plain_ms = greedy_decode(
        params, cfg, init_decode_state(params, cfg, MLA_B, MLA_CACHE,
                                       device="cuda"), first, MLA_STEPS)
    with shd.sharding_ctx(mesh, rules):
        state = shard_decode_state(
            init_decode_state(local, cfg, MLA_B, MLA_CACHE, device="cuda"),
            mesh, rules)
        toks, logits, state, ms = greedy_decode(local, cfg, state, first,
                                                MLA_STEPS)
    # what a mesh step adds at one rank: its collectives, each timed
    # alone on a decode row's residual [MLA_B, d] (host wall, synced)
    calls = []
    with shd.sharding_ctx(mesh, rules), counted_collectives(calls):
        decode_step(local, cfg, state, toks[:, -1:], MLA_STEPS)
    r = torch.zeros((MLA_B, cfg.d_model), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        shd.psum(r, "model", mesh)
    torch.cuda.synchronize()
    psum_ms = (time.perf_counter() - t0) * 1e3 / 50
    shapes = [tuple(v.shape) for v in state["layers"][0].values()]
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    check(torch.equal(toks, want_toks),
          f"MLA decode under the mesh: tokens {toks.tolist()} != "
          f"{want_toks.tolist()}")
    check(err <= MLA_TOL * scale,
          f"MLA decode under the mesh: max |diff| {err} > {MLA_TOL} x {scale}")
    return {"rows": MLA_B, "steps": MLA_STEPS, "cache": MLA_CACHE,
            "layers": cfg.num_layers, "cache_shapes": shapes,
            "tokens_equal": True, "tokens": toks.tolist(),
            "max_abs_diff": err, "max_abs_logit": scale,
            "step_ms": ms, "plain_step_ms": plain_ms,
            "collectives_per_step": {n: calls.count(n) for n in set(calls)},
            "psum_ms": psum_ms}


def hybrid_mesh_check(params, cfg, mesh, ops, seen):
    """(d) Jamba-1.5-Large (``cfg``'s layers) under the mesh: ``prefill``
    of PREFILL_B x PREFILL_S seeded tokens, the attention layers on the
    rank's heads (PR 27's path), the SSM layers split by head (``ssm``:
    the conv's columns handed to the heads by one ``all_to_all_single``,
    the norm's mean of squares and ``out_proj`` all-reduced) and the MoE
    expert-parallel (``moe_ep_shardmap``, counted: once a MoE layer at
    these 4096 tokens); flash attention and SSD chunk launched once a
    layer of their kind; bitwise ``prefill`` without a mesh
    (``mesh_prefill``)."""
    from repro_torch.models import moe as moe_lib
    ep_calls = []

    def counted(ep):
        return lambda *a, **kw: ep_calls.append(1) or ep(*a, **kw)

    with patched(moe_lib, "moe_ep_shardmap", counted):
        rep = mesh_prefill(params, cfg, "jamba-1.5-large-398b", mesh, ops,
                           seen, prefill_launches(cfg),
                           f"{cfg.name} prefill under the mesh")
    # once a MoE layer in each mesh prefill: the counted one and TURNS'
    runs = 1 + TURNS.count("mesh")
    moe_layers = sum(cfg.has_moe(i) for i in range(cfg.num_layers))
    check(len(ep_calls) == moe_layers * runs,
          f"{cfg.name} under the mesh: moe_ep_shardmap called "
          f"{len(ep_calls)} times in {runs} prefills, {moe_layers} MoE "
          f"layers")
    rep["ep_calls"] = len(ep_calls) // runs
    return rep


def ssm_mesh_check(params, cfg, mesh, ops, seen):
    """(e) Mamba2-2.7B (``cfg``'s layers) under the mesh: ``prefill`` of
    PREFILL_B x PREFILL_S seeded tokens through the head-split SSD mixer
    (``in_z`` / ``in_xbc`` / ``in_dt`` and the conv column-parallel, one
    ``all_to_all_single`` a layer handing the rank its heads' x channels
    and B and C, ``ssd_chunk`` on the rank's heads, the norm's mean of
    squares and ``out_proj`` all-reduced): SSD chunk once a layer, bitwise
    ``prefill`` without a mesh (``mesh_prefill``; the split norm's mean is
    the mean of one block mean at one rank). Then SSM_STEPS greedy
    ``decode_step``s of SSM_B rows from seeded tokens with the state cut
    by ``shard_decode_state`` (``ssd`` the rank's heads, ``conv`` whole:
    each step gathers the new xBC row) against the unsharded state:
    tokens equal, logits within SSM_TOL x max, and whether bitwise."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import shard_decode_state
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_decode_state
    rep = mesh_prefill(params, cfg, "mamba2-2.7b", mesh, ops, seen,
                       {"ssd_chunk": cfg.num_layers},
                       "head-split SSM prefill")
    rules = mesh_rules("mamba2-2.7b", mesh)
    local = shd.shard_params(params, mesh, rules)
    first = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, cfg.vocab_size, (SSM_B, 1))).cuda()
    want_toks, want, _, plain_ms = greedy_decode(
        params, cfg, init_decode_state(params, cfg, SSM_B, SSM_STEPS,
                                       device="cuda"), first, SSM_STEPS)
    with shd.sharding_ctx(mesh, rules):
        state = shard_decode_state(
            init_decode_state(local, cfg, SSM_B, SSM_STEPS, device="cuda"),
            mesh, rules)
        toks, logits, state, ms = greedy_decode(local, cfg, state, first,
                                                SSM_STEPS)
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    check(torch.equal(toks, want_toks),
          f"SSM decode under the mesh: tokens {toks.tolist()} != "
          f"{want_toks.tolist()}")
    check(err <= SSM_TOL * scale,
          f"SSM decode under the mesh: max |diff| {err} > {SSM_TOL} x "
          f"{scale}")
    rep["decode"] = {
        "rows": SSM_B, "steps": SSM_STEPS, "tokens_equal": True,
        "tokens": toks.tolist(), "bitwise": bool(torch.equal(logits, want)),
        "max_abs_diff": err, "max_abs_logit": scale,
        "state_shapes": [tuple(v.shape) for v in state["layers"][0].values()],
        "step_ms": ms, "plain_step_ms": plain_ms}
    return rep


@contextlib.contextmanager
def counting_collectives(counts):
    """Count every collective issued inside the block (the forward's,
    autograd's and the optimizer's) by kind into ``counts``: the c10d
    calls of ``torch.distributed`` the port makes and ``sharding``'s
    reduce-scatter and all-gather into one buffer."""
    import torch.distributed as dist
    from repro_torch.models import sharding as shd

    def counted(kind):
        def make(fn):
            def call(*a, **kw):
                counts[kind] = counts.get(kind, 0) + 1
                return fn(*a, **kw)
            return call
        return make

    with patched(dist, "all_reduce", counted("all-reduce")), \
            patched(dist, "all_gather", counted("all-gather")), \
            patched(dist, "all_to_all_single", counted("all-to-all")), \
            patched(shd, "_REDUCE_SCATTER", counted("reduce-scatter")), \
            patched(shd, "_ALL_GATHER_INTO", counted("all-gather")):
        yield


def mesh_step_collectives(cfg, rules, seq, leaves, moe_path):
    """The collectives of one train step under the (1, 1) mesh, by kind,
    from the layer kinds: each collective of the forward, again where
    remat's recomputation runs it (it stops at the last tensor the
    backward needs: a block's trailing all-reduce is not recomputed), and
    its transpose in the backward (over ``whole_layers``). With a model
    axis: an attention layer
    all-reduces after ``wo`` (forward, recomputed, backward: 3), a dense
    SwiGLU after ``w2`` (2); an expert-parallel MoE layer (``moe_path``
    "ep") exchanges twice (6 all-to-alls with the recomputation and the
    reverses), sums its aux over the batch and model axes (4 all-reduces)
    and gathers its rows along the sequence (1 all-gather, its
    reduce-scatter), a ``moe_capacity`` one with its experts split over
    the model axis gathers the batch's rows and its experts' outputs (4
    all-gathers with the recomputation, 2 reduce-scatters), and shared
    experts all-reduce as a dense SwiGLU does (2); an SSM layer
    redistributes its xBC columns (3 all-to-alls) and all-reduces the
    norm's block means (3) and ``out_proj`` (2); the embedding's d blocks
    are gathered (1 all-gather, 1 reduce-scatter), a tied embedding turned
    into vocab blocks (2 all-to-alls); the cross entropy's 512-position
    chunks all-reduce the row maxima and the exponentials' and label
    logits' sums (3 a chunk with the backward). With a batch axis the
    loss's sum is all-reduced (2). Then, from ``leaves`` ((param spec,
    moment spec, elements) of each leaf): a leaf whose moment spec is its
    param spec all-reduces its gradient once (over the whole mesh where
    the spec splits nothing, else over each axis it leaves whole: one at
    (1, 1)); a ZeRO-1 leaf (its moment spec adds an axis) reduce-scatters
    it once, all-reduces the block over each axis still whole (none where
    the param is split on the other one) and all-gathers the updated
    block once; an empty ZeRO-1 leaf does none of this. The global norm
    all-reduces once an axis for each distinct tuple of axes the moment
    specs split."""
    layers = whole_layers(cfg)
    kinds = [cfg.layer_kind(i) for i in range(layers)]
    n = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
         "all-to-all": 0}
    if rules.get("model") is not None:
        n_moe = sum(cfg.has_moe(i) for i in range(layers))
        n_ssm = kinds.count("ssm")
        n_ffn = 0 if cfg.family == "ssm" else layers - n_moe
        ep = moe_path == "ep"
        n["all-reduce"] += (3 * kinds.count("attn") + 2 * n_ffn
                            + (4 * ep + 2 * bool(cfg.num_shared_experts))
                            * n_moe + 5 * n_ssm + 3 * max(seq // 512, 1))
        n["all-to-all"] += 6 * ep * n_moe + 3 * n_ssm \
            + 2 * cfg.tie_embeddings
        n["all-gather"] += (1 if ep else 4) * n_moe + 1
        n["reduce-scatter"] += (1 if ep else 2) * n_moe + 1
    if rules.get("batch") is not None:
        n["all-reduce"] += 2
    axes = ("data", "model")
    norm = set()
    for spec, moment, numel in leaves:
        split = [a for e in spec for a in (e if isinstance(e, tuple)
                                           else (e,)) if a]
        names = tuple(a for e in moment for a in (e if isinstance(e, tuple)
                                                  else (e,)) if a)
        norm.add(names)
        zero1 = len(names) > len(split)
        if zero1 and not numel:
            continue
        whole = [a for a in axes if a not in names]
        n["all-reduce"] += 1 if len(whole) == len(axes) else len(whole)
        n["reduce-scatter"] += zero1
        n["all-gather"] += zero1
    n["all-reduce"] += sum(len(a) for a in norm)
    return {k: v for k, v in n.items() if v}


def step_leaves(params, cfg, rules, mesh):
    """(param spec, moment spec, elements) of each leaf of ``params``
    under ``cfg``'s specs on ``mesh`` with ``rules``."""
    from repro_torch.models import sharding as shd
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import leaf_specs
    from repro_torch.training.tree import leaves
    with shd.sharding_ctx(mesh, rules):
        return list(zip(
            leaf_specs(params, train_loop.param_specs(cfg)),
            leaf_specs(params, train_loop.opt_specs(cfg)["m"]),
            [p.numel() for p in leaves(params)]))


def train_batch(cfg, B, S):
    """B x S seeded tokens and labels on the card (Whisper's frames too)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 11)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 ).cuda() for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(size=(
            B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)).cuda()
    return batch


def train_launches(cfg):
    """A remat train step's launches: the flash forward twice and its
    backward once a self- or cross-attention layer (Whisper's encoder
    layers, outside remat, once each), the SSD chunk forward twice and its
    backward once an SSM layer."""
    kinds = prefill_launches(cfg)
    n_enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    n_attn, n_ssm = kinds["flash_attention"], kinds["ssd_chunk"]
    want = {"flash_attention": 2 * n_attn + n_enc,
            "flash_attention_bwd": n_attn + n_enc,
            "ssd_chunk": 2 * n_ssm, "ssd_chunk_bwd": n_ssm}
    return {k: v for k, v in want.items() if v}


def differing(tensors, host):
    """(index, max |diff|) of each card tensor that is not bitwise its
    host twin."""
    import torch
    out = []
    for i, (t, h) in enumerate(zip(tensors, host)):
        h = h.to(t.device)
        if not torch.equal(t, h):
            out.append((i, float((t.float() - h.float()).abs().max())))
    return out


def mesh_train_check(arch, layers, B, S, lr, moe_path, mesh, ops, seen):
    """(g) ``make_train_step`` under the (1, 1) mesh with ``arch``'s
    published rules (``cfg``: its layers, fp32), against the same step
    without a mesh: MESH_TRAIN_STEPS steps each from the seeded params
    and fresh optimizer states on B x S seeded tokens (Whisper with its
    encoder frames). Each mesh step's launches exactly the flash forward
    twice (remat) and its backward once a self- or cross-attention layer
    (Whisper's encoder layers, outside remat, once each), the SSD chunk
    forward twice and its backward once an SSM layer, as the plain
    step's; its collectives by kind as ``mesh_step_collectives`` counts
    them; the last step's loss, every gradient the optimizer saw and
    every param after it bitwise the plain step's (the plain results
    kept on the host between the runs, compared on the card). The
    heaviest kernel calls of the mesh steps go into ``seen`` (kernel ->
    call, as ``kernel_cases`` takes them). Then a step of each, warm, in
    TURNS on the same params (at one rank ``shard_params`` gives the same
    tensors). Returns the report."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step, train_loop)
    from repro_torch.training.tree import leaves
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rules = mesh_rules(arch, mesh)
    batch = train_batch(cfg, B, S)
    want = train_launches(cfg)

    def fresh():
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), device="cuda")
        return params, adamw_init(params)

    def steps(where, params, opt_state, want_grads=None):
        """MESH_TRAIN_STEPS steps: (params, opt_state, losses, launches
        and collectives a step, the last step's gradients): on the host,
        or, given ``want_grads`` (host tensors), the leaves that differ
        from them, each (leaf index, max |diff|), compared on the card as they
        come (the host holds one model's gradients, not two)."""
        step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=lr),
                               moe_path=moe_path if where == "mesh"
                               else "auto")
        got = {"grads": None, "step": 0}

        def keep(update):
            def call(grads, *a, **kw):
                got["step"] += 1
                if got["step"] == MESH_TRAIN_STEPS:
                    got["grads"] = ([g.cpu() for g in leaves(grads)]
                                    if want_grads is None
                                    else differing(leaves(grads), want_grads))
                return update(grads, *a, **kw)
            return call
        losses, launches, colls = [], [], []
        for _ in range(MESH_TRAIN_STEPS):
            counts = {}
            with contextlib.ExitStack() as stack:
                stack.enter_context(patched(train_loop, "adamw_update", keep))
                if where == "mesh":
                    stack.enter_context(shd.sharding_ctx(mesh, rules))
                    stack.enter_context(counting_collectives(counts))
                    stack.enter_context(recording(ops, seen, PREFILL_SPECS))
                    stack.enter_context(patched(flash_mod, "launch_bwd",
                                                keep_first_bwd(seen)))
                    stack.enter_context(patched(ssd_mod, "launch_bwd",
                                                keep_first_ssd_bwd(seen)))
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                params, opt_state, loss = step(params, opt_state, batch)
                torch.cuda.synchronize()
                launches.append(ops.launch_counts())
            losses.append(loss.cpu())
            colls.append(counts)
        return params, opt_state, losses, launches, colls, got["grads"]

    # pinned host memory the earlier phases left cached (their expert
    # masters): the plain run's gradients and params go to the host
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    t0 = time.perf_counter()
    params, opt_state = fresh()
    params, opt_state, p_losses, p_launches, _, p_grads = steps(
        "plain", params, opt_state)
    seen.clear()
    p_params = [t.cpu() for t in leaves(params)]
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    params, opt_state = fresh()
    local = shd.shard_params(params, mesh, rules)
    local, opt_state, losses, launches, colls, bad_grads = steps(
        "mesh", local, opt_state, p_grads)
    for name in PREFILL_SPECS:     # (size, call) -> the call
        if name in seen:
            seen[name] = seen[name][1]
    for i, (a, b) in enumerate(zip(p_launches, launches)):
        check_launches(a, want, f"{cfg.name} plain train step {i}")
        check_launches(b, want, f"{cfg.name} mesh train step {i}")
    want_colls = mesh_step_collectives(cfg, rules, S,
                                       step_leaves(params, cfg, rules, mesh),
                                       moe_path)
    for c in colls:
        check(c == want_colls, f"{cfg.name} mesh train step collectives "
                               f"{c}, expected {want_colls}")
    bad = {"loss": [] if torch.equal(losses[-1], p_losses[-1]) else
           [float((losses[-1] - p_losses[-1]).abs())],
           "grads": bad_grads, "params": differing(leaves(local), p_params)}
    check(not any(bad.values()), f"{cfg.name}: the mesh train step is not "
                                 f"bitwise the plain one: {bad}")
    del p_params, p_grads
    s = time.perf_counter() - t0
    # warm, on the same params and moments
    step = {w: make_train_step(cfg, opt_cfg=AdamWConfig(lr=lr),
                               moe_path=moe_path if w == "mesh" else "auto")
            for w in ("plain", "mesh")}
    turns = {"plain": [], "mesh": []}
    for turn in TURNS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with shd.sharding_ctx(mesh if turn == "mesh" else None,
                              rules if turn == "mesh" else {}):
            step[turn](local, opt_state, batch)
        torch.cuda.synchronize()
        turns[turn].append((time.perf_counter() - t1) * 1e3)
    del local, params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.num_layers, "batch": [B, S],
            "lr": lr, "moe_path": moe_path, "steps": MESH_TRAIN_STEPS,
            "losses_plain": [float(x) for x in p_losses],
            "losses_mesh": [float(x) for x in losses], "bitwise": True,
            "launches_per_step": launches[-1],
            "launches_mesh_steps": {k: sum(c.get(k, 0) for c in launches)
                                    for k in want},
            "collectives_per_step": colls[-1], "turns_ms": turns, "s": s}


def zero1_train_check(arch, layers, B, S, lr, moe_path, dtype, mesh, ops,
                      seen):
    """(h) ZeRO-1 under the (1, 1) mesh: ``make_train_step`` of a
    ``zero1`` config (``arch`` at its published widths, ``layers`` of
    them, in ``dtype``) with its published rules and the moments of
    ``init_opt_state`` (cut on "data" by ``opt_state_pspecs``: at one rank
    a leaf's one block is all of it, so the step's reduce-scatter and
    all-gather of every non-empty ZeRO-1 leaf run through NCCL), against
    the step without a mesh (the mesh step on ``moe_path``, the plain one
    on "auto"), MESH_TRAIN_STEPS steps from the same seeded params on B x
    S seeded tokens. Both steps run from the same state in
    lockstep, so the host keeps one model's worth: before each step the
    params and moments go to pinned host buffers; the plain step runs
    (its gradients to pinned buffers as AdamW gets them); its results
    and the saved state swap places, leaf by leaf; the mesh step runs from
    the same state. Each step's loss, every gradient the optimizer saw
    and every param and moment after it are bitwise the plain step's
    (compared on the card); its launches are ``train_launches``' as the
    plain step's; its collectives by kind are ``mesh_step_collectives``'.
    The heaviest kernel calls of the mesh steps go into ``seen``. Then a
    step of each, warm, in TURNS on the same params and moments. Returns
    the report, with the card's peak allocation and the host's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import init_params
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step, train_loop)
    from repro_torch.training.tree import leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype=dtype)
    rules = mesh_rules(arch, mesh)
    batch = train_batch(cfg, B, S)
    want = train_launches(cfg)
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    plan = step_leaves(params, cfg, rules, mesh)
    zero1 = sum(p != m for p, m, _ in plan)
    zero1_full = sum(n > 0 and p != m for p, m, n in plan)
    check(zero1_full > 0, f"{cfg.name}: no ZeRO-1 leaf under {rules}")
    want_colls = mesh_step_collectives(cfg, rules, S, plan, moe_path)
    with shd.sharding_ctx(mesh, rules):
        local = shd.shard_params(params, mesh, rules)
        opt_state = init_opt_state(local, cfg)
    del params
    step = {w: make_train_step(cfg, opt_cfg=AdamWConfig(lr=lr),
                               moe_path=moe_path if w == "mesh" else "auto")
            for w in ("plain", "mesh")}

    def state():
        return leaves(local) + leaves(opt_state["m"]) + leaves(opt_state["v"])

    def pinned(tensors):
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]

    host_free = mem_available()
    host = pinned(state())
    host_grads = pinned(leaves(local))
    host_bytes = sum(t.numel() * t.element_size() for t in host + host_grads)
    got = {"bad_grads": []}

    def keep(update):
        def call(grads, *a, **kw):
            for h, g in zip(host_grads, leaves(grads)):
                h.copy_(g)
            return update(grads, *a, **kw)
        return call

    def compare(update):
        def call(grads, *a, **kw):
            got["bad_grads"] = differing(leaves(grads), host_grads)
            return update(grads, *a, **kw)
        return call

    losses, launches, colls = {"plain": [], "mesh": []}, [], []
    for k in range(MESH_TRAIN_STEPS):
        for h, t in zip(host, state()):
            h.copy_(t)
        count = opt_state["count"].clone()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with patched(train_loop, "adamw_update", keep):
            local, opt_state, loss = step["plain"](local, opt_state, batch)
        torch.cuda.synchronize()
        p_launches = ops.launch_counts()
        losses["plain"].append(loss.cpu())
        p_count = opt_state["count"].clone()
        for h, t in zip(host, state()):     # the saved state back
            after = t.clone()
            t.copy_(h)
            h.copy_(after)
            del after
        opt_state["count"] = count
        counts = {}
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(train_loop, "adamw_update", compare))
            stack.enter_context(shd.sharding_ctx(mesh, rules))
            stack.enter_context(counting_collectives(counts))
            stack.enter_context(recording(ops, seen, PREFILL_SPECS))
            stack.enter_context(patched(flash_mod, "launch_bwd",
                                        keep_first_bwd(seen)))
            stack.enter_context(patched(ssd_mod, "launch_bwd",
                                        keep_first_ssd_bwd(seen)))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            local, opt_state, loss = step["mesh"](local, opt_state, batch)
            torch.cuda.synchronize()
            launches.append(ops.launch_counts())
        losses["mesh"].append(loss.cpu())
        colls.append(counts)
        check_launches(p_launches, want, f"{cfg.name} plain step {k}")
        check_launches(launches[-1], want, f"{cfg.name} ZeRO-1 step {k}")
        check(counts == want_colls, f"{cfg.name} ZeRO-1 step {k} "
                                    f"collectives {counts}, expected "
                                    f"{want_colls}")
        bad = {"loss": [] if torch.equal(losses["mesh"][-1],
                                         losses["plain"][-1])
               else [float(losses["mesh"][-1] - losses["plain"][-1])],
               "grads": got["bad_grads"],
               "state": differing(state(), host),
               "count": [] if torch.equal(opt_state["count"], p_count)
               else [int(opt_state["count"])]}
        check(not any(bad.values()), f"{cfg.name}: ZeRO-1 step {k} is not "
                                     f"bitwise the plain one: {bad}")
    for name in PREFILL_SPECS:     # (size, call) -> the call
        if name in seen:
            seen[name] = seen[name][1]
    del host, host_grads
    peak = torch.cuda.max_memory_allocated()
    s = time.perf_counter() - t0
    turns = {"plain": [], "mesh": []}
    for turn in TURNS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with shd.sharding_ctx(mesh if turn == "mesh" else None,
                              rules if turn == "mesh" else {}):
            step[turn](local, opt_state, batch)
        torch.cuda.synchronize()
        turns[turn].append((time.perf_counter() - t1) * 1e3)
    del local, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    return {"model": cfg.name, "layers": cfg.num_layers, "dtype": dtype,
            "batch": [B, S], "lr": lr, "moe_path": moe_path,
            "steps": MESH_TRAIN_STEPS,
            "leaves": len(plan), "zero1_leaves": zero1,
            "zero1_leaves_nonempty": zero1_full,
            "losses_plain": [float(x) for x in losses["plain"]],
            "losses_mesh": [float(x) for x in losses["mesh"]],
            "bitwise": True, "launches_per_step": launches[-1],
            "launches_mesh_steps": {k: sum(c.get(k, 0) for c in launches)
                                    for k in want},
            "collectives_per_step": colls[-1],
            "peak_device_bytes": peak, "host_pinned_bytes": host_bytes,
            "host_available_before_bytes": host_free,
            "turns_ms": turns, "s": s}


def _cross_call(q, k, **kw):
    """Whether a flash attention call is a cross-attention one: no mask,
    queries over another sequence's keys."""
    return not kw.get("causal", True) and q.shape[1] != k.shape[1]


def flash_kinds(ops, counts):
    """Count the ``ops.flash_attention`` calls inside the block by kind
    into ``counts``: "cross" (``_cross_call``) or "self"."""
    def make(flash):
        def call(q, k, v, **kw):
            kind = "cross" if _cross_call(q, k, **kw) else "self"
            counts[kind] = counts.get(kind, 0) + 1
            return flash(q, k, v, **kw)
        return call
    return patched(ops, "flash_attention", make)


# the heaviest self-attention call and the heaviest cross-attention call
SELF_SPECS, CROSS_SPECS = ({"flash_attention": (
    lambda q, k, v, cross=cross, **kw: (pairs_times_heads(q, k, v, **kw)
                                        if _cross_call(q, k, **kw) == cross
                                        else -1),
    PREFILL_SPECS["flash_attention"][1])} for cross in (False, True))


def cross_mesh_check(params, cfg, arch, mesh, ops, self_seen, cross_seen, fe,
                     enc, seq):
    """(f) Whisper-tiny or Llama-3.2-Vision (``cfg``'s layers) under the
    mesh with the published arch's rules (Whisper-tiny's are data
    parallel only: its weights whole; Vision's split the heads and ff
    blocks): encdec first runs ``encoder_forward`` over the seeded frames
    ``fe`` (flash attention once an encoder layer), bitwise ``enc`` (the
    unsharded encoder states); then ``prefill`` of PREFILL_B x ``seq``
    tokens over ``enc`` (the cross layers on the rank's heads over its
    rows), bitwise the unsharded prefill (``mesh_prefill``: flash once a
    self-attention and once a cross layer). The heaviest self-attention
    call of both goes into ``self_seen``, the heaviest cross call into
    ``cross_seen``, and their calls are counted by kind
    (``flash_launches``: they sum to the wrapper's launches). Then
    CROSS_STEPS greedy ``decode_step``s of CROSS_B rows from seeded
    tokens, the state built whole from the whole params under the mesh
    and cut by ``shard_decode_state`` (its ``cross_kv`` the rank's rows
    and heads), against the unsharded state: tokens equal, logits within
    CROSS_TOL x max, and whether bitwise; flash once a cross layer a step.
    One more step counts its collectives."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import shard_decode_state
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import (decode_step,
                                                encoder_forward,
                                                init_decode_state)
    rules = mesh_rules(arch, mesh)
    local = shd.shard_params(params, mesh, rules)
    rep = {"rules_model_axis": rules.get("model")}
    kinds, total = {}, 0
    if cfg.family == "encdec":
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with shd.sharding_ctx(mesh, rules), \
                recording(ops, self_seen, SELF_SPECS), \
                flash_kinds(ops, kinds):
            got = encoder_forward(local, cfg, fe)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        check_launches(launches, {"flash_attention": cfg.encoder_layers},
                       f"{cfg.name} encoder under the mesh")
        err = float((got - enc).abs().max())
        check(torch.equal(got, enc), f"{cfg.name} encoder under the mesh != "
                                     f"unsharded: max |diff| {err}")
        rep["encoder"] = {"frames": fe.shape[1], "launches": launches,
                          "bitwise": True, "max_abs_diff": err, "ms": ms}
        total += launches["flash_attention"]
    rep["prefill"] = mesh_prefill(params, cfg, arch, mesh, ops, {},
                                  prefill_launches(cfg),
                                  f"{cfg.name} prefill under the mesh",
                                  seq=seq, enc=enc,
                                  also=(recording(ops, self_seen, SELF_SPECS),
                                        recording(ops, cross_seen,
                                                  CROSS_SPECS),
                                        flash_kinds(ops, kinds)))
    total += rep["prefill"]["launches"]["flash_attention"]
    check(sum(kinds.values()) == total
          and kinds.get("cross") == cross_layers(cfg),
          f"{cfg.name} under the mesh: flash calls by kind {kinds}, "
          f"{total} launches, {cross_layers(cfg)} cross layers")
    rep["flash_launches"] = kinds
    first = torch.from_numpy(np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (CROSS_B, 1))).cuda()
    rows = enc[:CROSS_B]
    cache = CROSS_STEPS + 1
    want_toks, want, _, plain_ms = greedy_decode(
        params, cfg, init_decode_state(params, cfg, CROSS_B, cache,
                                       enc=rows, device="cuda"),
        first, CROSS_STEPS)
    with shd.sharding_ctx(mesh, rules):
        state = shard_decode_state(
            init_decode_state(params, cfg, CROSS_B, cache, enc=rows,
                              device="cuda"), mesh, rules)
        ops.reset_launch_counts()
        toks, logits, state, ms = greedy_decode(local, cfg, state, first,
                                                CROSS_STEPS)
        launches = ops.launch_counts()
        calls = []
        with counted_collectives(calls):
            decode_step(local, cfg, state, toks[:, -1:], CROSS_STEPS)
    check_launches(launches, {"flash_attention": cross_layers(cfg)
                              * CROSS_STEPS},
                   f"{cfg.name} decode under the mesh")
    err = float((logits - want).abs().max())
    scale = float(want.abs().max())
    check(torch.equal(toks, want_toks),
          f"{cfg.name} decode under the mesh: tokens {toks.tolist()} != "
          f"{want_toks.tolist()}")
    check(err <= CROSS_TOL * scale,
          f"{cfg.name} decode under the mesh: max |diff| {err} > "
          f"{CROSS_TOL} x {scale}")
    rep["decode"] = {
        "rows": CROSS_B, "steps": CROSS_STEPS, "tokens_equal": True,
        "tokens": toks.tolist(), "bitwise": bool(torch.equal(logits, want)),
        "max_abs_diff": err, "max_abs_logit": scale, "launches": launches,
        "cross_kv_shape": list(state["cross_kv"][0]["k"].shape),
        "collectives_per_step": {n: calls.count(n) for n in sorted(set(
            calls))},
        "step_ms": ms, "plain_step_ms": plain_ms}
    return rep


def family_phase(arch, ops, card, hold_and_time, profile, mesh=None,
                 dtype="float32", routed=True):
    """One model of the hybrid, encdec or vlm family at its published
    widths, depth cut as JAMBA_LAYERS / VLM_LAYERS say (Whisper-tiny
    whole), in ``dtype`` (fp32, or the config's own bf16), random weights
    drawn on the card from the seeded generator: ``prefill_phase`` (the
    engine comparison with ``enc=``, exact launch counts from the layer
    kinds, finite logits) on
    PREFILL_B x PREFILL_S tokens (Whisper: its WHISPER_S-token text
    context). encdec: the encoder first runs over 1500 seeded frames,
    launching flash attention once a layer, non-causal; vlm: 1601
    seeded patch embeddings; both in ``dtype``. The phase's heaviest
    flash attention and SSD chunk calls are held against their plain
    versions and timed (``hold_and_time``, entries marked with the model
    and a dtype other than fp32), and so is the engine's cross call, the
    one-query route's, with the engine's launches, then checked by
    ``one_query_checks`` (``routed`` False: the engine's calls take the
    tile kernel, and its call is not held). With ``mesh``, the hybrid
    then runs ``hybrid_mesh_check`` (its kernel calls held and timed as
    entries of their own; the report's "mesh_prefill"), the encdec and
    vlm ``cross_mesh_check``. Then the params are freed. Returns the
    report."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import encoder_forward, init_params

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    label = cfg.name if dtype == "float32" else f"{cfg.name} {dtype}"
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=JAMBA_LAYERS,
                                  attn_every=JAMBA_LAYERS)
    elif cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    setup = {"setup_s": time.perf_counter() - t0,
             "device_bytes_allocated": torch.cuda.memory_allocated()}
    rng = np.random.default_rng(SEED + 3)
    seen, enc, rep = {}, None, {"dtype": dtype}
    encoder = {name: 0 for name in ops.LAUNCHES}

    def seeded(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(getattr(torch, dtype))

    if cfg.family == "encdec":
        frames = seeded(PREFILL_B, cfg.encoder_frames, cfg.d_model)
        with recording(ops, seen, PREFILL_SPECS):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            enc = encoder_forward(params, cfg, frames)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            encoder = ops.launch_counts()
        check_launches(encoder, {"flash_attention": cfg.encoder_layers},
                       f"{cfg.name} encoder")
        check(tuple(enc.shape) == (PREFILL_B, cfg.encoder_frames,
                                   cfg.d_model) and enc.dtype == frames.dtype
              and bool(torch.isfinite(enc).all()),
              f"{cfg.name}: encoder states {tuple(enc.shape)} {enc.dtype}")
        rep["encoder"] = {"frames": cfg.encoder_frames, "ms": ms,
                          "launches": encoder}
    elif cfg.family == "vlm":
        enc = seeded(PREFILL_B, cfg.num_image_tokens, cfg.d_model)
    seqs = (dict(engine_s=WHISPER_S, prefill_s=WHISPER_S)
            if cfg.family == "encdec" else {})
    engine_call = {}
    launches, prefill_rep = prefill_phase(
        params, cfg, ops, seen, profile, enc=enc, engine_call=engine_call,
        routed=routed, **seqs)
    rep.update(prefill_rep, setup=setup, card=card)
    hold_and_time({k: v[1] for k, v in seen.items()},
                  {k: launches[k] + encoder[k] for k in launches},
                  model=label)
    if engine_call and routed:
        # the one-query route's calls: the engine's cross call, held and
        # timed with the engine's launches, then against float64, twice
        # for bitwise equal outputs, and row and head independent
        hold_and_time(engine_call, {"flash_attention": rep["engine"][
            "engine_launches"]["flash_attention"]},
            model=f"{label} engine, one-query route")
        q, k, v, kw = engine_call["flash_attention"]
        rep["engine"]["flash_call"] = one_query_checks(
            ops, q, k, v, ops.flash_attention(q, k, v, **kw), kw,
            f"{label} engine call")
    if mesh is not None and cfg.family == "hybrid":
        t0 = time.perf_counter()
        mesh_seen = {}
        rep["mesh_prefill"] = hybrid_mesh_check(params, cfg, mesh, ops,
                                                mesh_seen)
        hold_and_time({k: v[1] for k, v in mesh_seen.items()},
                      {k: rep["mesh_prefill"]["launches"][k]
                       for k in mesh_seen},
                      model=f"{cfg.name} under the (1, 1) mesh")
        rep["mesh_prefill"]["s"] = time.perf_counter() - t0
    elif mesh is not None:
        t0 = time.perf_counter()
        self_seen, cross_seen = {}, {}
        rep["mesh_cross"] = cross_mesh_check(
            params, cfg, arch, mesh, ops, self_seen, cross_seen,
            frames if cfg.family == "encdec" else None, enc,
            seqs.get("prefill_s", PREFILL_S))
        # the mesh path's launches of each kind: its prefill's and
        # (encdec) encoder's
        kinds = rep["mesh_cross"]["flash_launches"]
        for what, kind, calls in (("self-attention", "self", self_seen),
                                  ("cross", "cross", cross_seen)):
            hold_and_time({"flash_attention": calls["flash_attention"][1]},
                          {"flash_attention": kinds[kind]},
                          model=f"{cfg.name} under the (1, 1) mesh, {what}")
        rep["mesh_cross"]["s"] = time.perf_counter() - t0
    del params, seen, enc
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def no_backward_checks():
    """ROADMAP.md C3 on the card: the decode-only kernels, which have no
    backward, refuse an input that requires grad (they would cut the
    gradient silently), and launch nothing. Returns each refusal's
    message."""
    import torch
    from repro_torch.kernels import ops

    def t(*shape, grad=False):
        return torch.zeros(shape, device="cuda").requires_grad_(grad)

    idx = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                     device="cuda")
    calls = {
        "moe_ffn": lambda: ops.moe_ffn(t(1, 8, 64), t(1, 64, 32, grad=True),
                                       t(1, 64, 32), t(1, 32, 64), [0]),
        "paged_attention": lambda: ops.paged_attention(
            t(1, 4, 64, grad=True), t(2, 16, 1, 64), t(2, 16, 1, 64),
            idx(1, 2), idx(1)),
    }
    before, out = ops.launch_counts(), {}
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
            continue
        check(False, f"{name}: no error under grad on the card")
    check(ops.launch_counts() == before, "a refused call launched")
    return out


def keep_first_bwd(seen):
    """``make`` for ``patched(flash_mod, "launch_bwd", ...)``: keeps copies
    of the first backward call's arguments in ``seen`` (every attention
    layer of a model is called at one shape)."""
    def make(launch_bwd):
        def call(fn, q, k, v, dout, **kw):
            if "flash_attention_bwd" not in seen:
                seen["flash_attention_bwd"] = tuple(
                    t.detach().clone() for t in (q, k, v, dout)) + (dict(kw),)
            return launch_bwd(fn, q, k, v, dout, **kw)
        return call
    return make


def keep_first_ssd_bwd(seen):
    """``make`` for ``patched(ssd_mod, "launch_bwd", ...)``: keeps copies of
    the first SSD backward call's arguments in ``seen`` (every SSM layer of
    a model is called at one shape)."""
    def make(launch_bwd):
        def call(fn, *args):
            if "ssd_chunk_bwd" not in seen:
                seen["ssd_chunk_bwd"] = tuple(t.detach().clone()
                                              for t in args)
            return launch_bwd(fn, *args)
        return call
    return make


def train_step_compare(cfg, batch, ops, lr):
    """One ``make_train_step`` step (AdamW at ``lr``, no schedule) from
    the seeded params through the kernels, and the same step with
    ``flash_attention.plain`` patched into ``attention._sdpa`` (autograd
    of the plain version: no launch), in ``cfg``'s dtype. Loss, global
    grad norm, every gradient and the post-AdamW params must agree as
    STEP_TOL says for that dtype."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import init_params
    from repro_torch.training import (AdamWConfig, adamw_init, global_norm,
                                      make_train_step, train_loop)
    from repro_torch.training.tree import leaves

    def plain_sdpa(_):
        return lambda q, k, v, *, causal, window: flash_mod.plain(
            q, k, v, causal=causal, window=window or 0)

    runs = {}
    for route in ("kernel", "plain"):
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(SEED), device="cuda")
        seen = {}

        def keep_grads(update):
            def call(grads, opt_state, params, **kw):
                seen["grads"] = [g.detach().clone() for g in leaves(grads)]
                seen["norm"] = global_norm(grads)
                return update(grads, opt_state, params, **kw)
            return call

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(train_loop, "adamw_update",
                                        keep_grads))
            if route == "plain":
                stack.enter_context(patched(attn_mod, "_sdpa", plain_sdpa))
            step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=lr))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            params, _, loss = step(params, adamw_init(params), batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = ops.launch_counts()
        runs[route] = (leaves(params), seen["grads"], float(seen["norm"]),
                       float(loss), launches, ms)
    (pk, gk, nk, lk, launch_k, ms_k), (pp, gp, np_, lp, launch_p, ms_p) = \
        runs["kernel"], runs["plain"]
    n_attn = prefill_launches(cfg)["flash_attention"]
    check_launches(launch_k, {"flash_attention": 2 * n_attn,
                              "flash_attention_bwd": n_attn},
                   f"{cfg.name} kernel step")
    check_launches(launch_p, {}, f"{cfg.name} plain step")
    tol, g_tol, p_tol = STEP_TOL[cfg.dtype]
    loss_err, norm_err = abs(lk - lp) / abs(lp), abs(nk - np_) / np_
    check(loss_err <= tol and norm_err <= tol,
          f"kernel vs plain step: loss {lk} vs {lp}, grad norm {nk} vs {np_}")
    g_top = max(float(g.abs().max()) for g in gp)
    g_err = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(gk, gp))
    check(g_err <= g_tol * g_top,
          f"kernel vs plain gradients ({cfg.dtype}): max |diff| "
          f"{g_err:.3e}, max |g| {g_top:.3e}")
    p_err, flipped = 0.0, 0
    for a, b, ga, gb in zip(pk, pp, gk, gp):
        a, b, ga, gb = a.float(), b.float(), ga.float(), gb.float()
        d = (a - b).abs()
        sens = 2 * ((ga - gb).abs() / gb.abs().clamp_min(1e-30) + norm_err)
        allowed = lr * sens.clamp(max=2.0) + p_tol * (b.abs() + lr)
        check(bool((d <= allowed).all()),
              f"kernel vs plain post-AdamW params: |diff| "
              f"{float((d - allowed).max()):.3e} over what the gradients "
              f"explain")
        p_err = max(p_err, float(d.max()))
        flipped += int((d > lr).sum())
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "grad_norm_kernel": nk, "grad_norm_plain": np_,
            "grad_norm_rel_err": norm_err, "grad_max_abs_err": g_err,
            "grad_max_abs": g_top, "params_max_abs_err": p_err,
            "params_off_by_more_than_lr": flipped,
            "params": sum(t.numel() for t in pp), "dtype": cfg.dtype,
            "tol": STEP_TOL[cfg.dtype],
            "step_ms_kernel": ms_k, "step_ms_plain": ms_p,
            "launches_kernel": launch_k}


def counted_steps(want, what, stamps, launches, kept):
    """``make`` for ``patched(<module>, "train", ...)``: the module's
    ``train`` runs with a callback that checks each step's launches (set
    to 0 just before the call and after each step, read after each step)
    against ``want`` exactly, and stamps each step's end on the host
    clock after a synchronize (``stamps[0]``: the call's start, so step
    0 includes the params' init). ``kept["params"]`` gets the trained
    params."""
    import torch
    from repro_torch.kernels import ops

    def make(train):
        def call(*args, **kw):
            def after_step(i, params, loss):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                counts = ops.launch_counts()
                ops.reset_launch_counts()
                check_launches(counts, want, f"{what} train step {i}")
                launches.append(counts)

            torch.cuda.synchronize()
            ops.reset_launch_counts()
            stamps.append(time.perf_counter())
            params, losses = train(*args, callback=after_step, **kw)
            kept["params"] = params
            return params, losses
        return call
    return make


def step_summary(stamps, batch_tokens):
    """Per-step ms from ``counted_steps``' stamps, and the median of the
    steps after the first (which includes the init) in ms and tokens/s."""
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    rest = sorted(ms[1:]) or ms
    median = rest[len(rest) // 2]
    return {"step_ms": ms, "median_step_ms": median,
            "tokens_per_s": batch_tokens / median * 1e3}


def training_phase(ops, card, hold_and_time, profile):
    """TRAIN_RUNS through ``repro_torch.training.train`` on ``lm_batches``
    at published widths (the hybrid reduced, see TRAIN_RUNS; params drawn
    on the card from the seed, in each run's dtype, remat): every step's
    launches, reset
    just before it and read just after it (in ``train``'s callback), must
    be exactly the flash forward twice (once more under remat) and its
    backward once per attention layer, the SSD chunk forward twice and its
    backward once per SSM layer, and nothing else; every loss finite and
    the last below the first. STEP_COMPARE_ARCH first runs
    ``train_step_compare`` in each of STEP_TOL's dtypes. Prints a
    ``train_step`` line a step and a ``train_summary`` line a run (median
    step, tokens/s, peak device bytes); holds each backward kernel
    against its plain version at each model's first call and times it
    (``hold_and_time``), against float64
    (``bwd_against_float64``, ``ssd_bwd_checks``), and launches it twice
    on that call for bitwise equal outputs; the flash forward likewise
    at the same call, in every run that records a flash backward call
    (``fwd_against_float64``,
    ``fwd_repeat_bitwise``); times the SSD backward at
    JAMBA_SSD_SHAPE off the path; with ``profile``, traces one more step
    of each whole model, GLUE_ARCH's with the host stacks, and prints a
    ``glue`` line: the ops behind its elementwise adds and fills
    (``glue_sources``). Returns the report."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import lm_batches
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ssd_chunk as ssd_mod
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step, train)
    from repro_torch.training.train_loop import to_device
    from repro_torch.training.tree import leaves

    rep = {"card": card, "no_backward": no_backward_checks()}
    for arch, layers, B, S, steps, lr, dtype in TRAIN_RUNS:
        cfg = get_config(arch)
        if isinstance(layers, dict):
            cfg = reduced(cfg, **layers)
        elif layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, dtype=dtype)
        t0 = time.perf_counter()
        batches = list(lm_batches(cfg.vocab_size, B, S, steps, seed=SEED))
        run = {"model": cfg.name, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "dtype": dtype, "batch": B, "seq": S,
               "steps": steps, "lr": lr, "data_s": time.perf_counter() - t0}
        if arch == STEP_COMPARE_ARCH:
            for dt in STEP_TOL:
                run[f"kernel_vs_plain_step_{dt}"] = train_step_compare(
                    dataclasses.replace(cfg, dtype=dt),
                    to_device(batches[0], "cuda"), ops, lr)
                gc.collect()
                torch.cuda.empty_cache()
        kinds = prefill_launches(cfg)
        n_attn, n_ssm = kinds["flash_attention"], kinds["ssd_chunk"]
        want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
                "ssd_chunk": 2 * n_ssm, "ssd_chunk_bwd": n_ssm}
        stamps, launches, seen, kept = [], [], {}, {}
        torch.cuda.reset_peak_memory_stats()
        with patched(flash_mod, "launch_bwd", keep_first_bwd(seen)), \
                patched(ssd_mod, "launch_bwd", keep_first_ssd_bwd(seen)):
            params, losses = counted_steps(
                want, cfg.name, stamps, launches, kept)(train)(
                cfg, iter(batches), steps=steps, seed=SEED, log_every=0,
                opt_cfg=AdamWConfig(lr=lr), device="cuda")
        kept.clear()
        summary = step_summary(stamps, B * S)
        for i, (ms, loss) in enumerate(zip(summary["step_ms"], losses)):
            print(json.dumps({"train_step": {
                "model": cfg.name, "dtype": dtype, "step": i, "ms": ms,
                "tokens_per_s": B * S / ms * 1e3, "loss": loss,
                "first_step_includes_init": i == 0}}), flush=True)
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"{cfg.name}: losses {losses}")
        check(losses[-1] < losses[0],
              f"{cfg.name}: loss did not fall: {losses}")
        run.update(losses=losses, **summary,
                   launches_per_step=launches[0],
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   params=sum(p.numel() for p in leaves(params)))
        print(json.dumps({"train_summary": {
            "model": cfg.name, "layers": cfg.num_layers, "dtype": dtype,
            "batch": B, "seq": S, "median_step_ms": summary["median_step_ms"],
            "tokens_per_s": summary["tokens_per_s"],
            "peak_device_bytes": run["peak_device_bytes"],
            "params": run["params"], "card": card}}), flush=True)
        if profile and layers is None:
            step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=lr))
            opt_state = adamw_init(params)
            batch = to_device(batches[-1], "cuda")
            act = torch.profiler.ProfilerActivity
            glue = arch == GLUE_ARCH
            prof = torch.profiler.profile(activities=[act.CPU, act.CUDA],
                                          with_stack=glue)
            torch.cuda.synchronize()
            prof.start()
            t0 = time.perf_counter()
            step(params, opt_state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            prof.stop()
            run["profile"] = device_time_summary(prof, ms)
            if glue:
                run["glue"] = glue_sources(prof)
                print(json.dumps({"glue": {"model": cfg.name,
                                           **run["glue"]}}), flush=True)
            del opt_state, step
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if "flash_attention_bwd" in seen:
            run["bwd_vs_float64"] = bwd_against_float64(
                ops, *seen["flash_attention_bwd"])
            run["bwd_bitwise_repeat"] = bwd_repeat_bitwise(
                ops, *seen["flash_attention_bwd"])
        if "ssd_chunk_bwd" in seen:
            run["ssd_bwd_checks"] = ssd_bwd_checks(ops, seen["ssd_chunk_bwd"])
        check(sorted(seen) == sorted(k for k in ("flash_attention_bwd",
                                                 "ssd_chunk_bwd") if want[k]),
              f"{cfg.name}: backward calls recorded {sorted(seen)}")
        if "flash_attention_bwd" in seen:
            # the forward at the same call (twice a layer a step under
            # remat), held and timed beside SDPA's forward in its dtype
            q, k, v, _, kw = seen["flash_attention_bwd"]
            seen["flash_attention"] = (q, k, v, kw)
            run["fwd_vs_float64"] = fwd_against_float64(ops, q, k, v, kw)
            run["fwd_bitwise_repeat"] = fwd_repeat_bitwise(ops, q, k, v, kw)
        hold_and_time(seen, {k: sum(c[k] for c in launches) for k in seen},
                      model=cfg.name)
        del seen
        gc.collect()
        torch.cuda.empty_cache()
        rep[cfg.name] = run
    # the SSD backward at Jamba's published SSD call, off the path (seeded
    # inputs, dA < 0): held against its plain version and timed
    rng = np.random.default_rng(SEED + 5)
    G, Q, H, P, N = JAMBA_SSD_SHAPE

    def rand(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    args = (-0.1 * rand(G, Q, H).abs(), rand(G, Q, H, P), rand(G, Q, N),
            rand(G, Q, N), rand(G, Q, H, P), rand(G, H, P, N))
    rep["ssd_bwd_jamba_shape"] = hold_and_time(
        {"ssd_chunk_bwd": args}, None,
        model="jamba-1.5-large-398b published SSD shape, off the path")
    del args
    torch.cuda.empty_cache()
    return rep


def captured(fn, *args):
    """(fn(*args), what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def timed_decode(runs):
    """``make`` for ``patched(OffloadEngine, "decode_tokens", ...)``: each
    engine's decode steps' wall ms (synchronized before and after) go to
    a list of their own in ``runs``, one list an engine, in the order the
    engines first decode."""
    import torch

    def make(decode_tokens):
        def call(self, *args, **kw):
            if self._steps_done == 0:
                runs.append([])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode_tokens(self, *args, **kw)
            torch.cuda.synchronize()
            runs[-1].append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    return make


def train_cli_run(ops, card, hold_and_time):
    """(a) ``repro_torch.launch.train.main`` in-process on Qwen1.5-0.5B
    whole in its published dtype, bf16: every step launches the flash
    forward twice (remat) and its backward once per layer and nothing
    else; the printed final loss is finite; the checkpoint loads with
    ``load_checkpoint`` into an ``init_params`` tree of the config (the
    file's keys exactly, shapes, dtypes, finite, ``step`` 3) and equals
    the trained params bitwise (bf16 leaves are stored as fp32, which
    holds them exactly). The run's first flash backward call, and the
    forward at the same inputs, are held against their plain versions and
    timed (``hold_and_time``), against float64, and launched twice for
    bitwise equal outputs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch import train as train_cli
    from repro_torch.models.transformer import init_params
    from repro_torch.training import load_checkpoint
    from repro_torch.training.tree import flatten

    rep = {"card": card, "argv": LAUNCH_TRAIN}
    cfg = get_config("qwen1.5-0.5b")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "qwen.npz")
        argv = LAUNCH_TRAIN + ["--ckpt", path]
        L = prefill_launches(cfg)["flash_attention"]
        stamps, launches, kept, seen = [], [], {}, {}
        with patched(train_cli, "train",
                     counted_steps({"flash_attention": 2 * L,
                                    "flash_attention_bwd": L}, "train CLI",
                                   stamps, launches, kept)), \
                patched(flash_mod, "launch_bwd", keep_first_bwd(seen)):
            _, text = captured(train_cli.main, argv)
        m = re.search(r"final loss (\S+) \(start (\S+)\)", text)
        check(m is not None and f"saved {path}" in text,
              f"train CLI printed {text!r}")
        last, first = float(m.group(1)), float(m.group(2))
        check(np.isfinite(last) and np.isfinite(first),
              f"train CLI losses {first} -> {last}")
        check(len(launches) == 3, f"train CLI ran {len(launches)} steps")
        rep.update(step_summary(stamps, 4 * 2048), dtype=cfg.dtype,
                   loss_first=first, loss_last=last,
                   launches_per_step=launches[0],
                   ckpt_bytes=os.path.getsize(path))
        like = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED + 1), device="cuda")
        with np.load(path) as z:
            keys = sorted(k for k in z.files if k != "__meta__")
        tree, step = load_checkpoint(path, like)
        trained = dict(flatten(kept.pop("params")))
        check(step == 3, f"checkpoint step {step}")
        check(keys == sorted(k for k, _ in flatten(like)),
              "checkpoint keys differ from the init tree's")
        for (k, t), (_, ref) in zip(flatten(tree), flatten(like)):
            check(t.shape == ref.shape and t.dtype == ref.dtype
                  and t.device == ref.device, f"checkpoint {k}")
            check(bool(torch.isfinite(t).all()), f"checkpoint {k} finite")
            check(torch.equal(t, trained[k]),
                  f"checkpoint {k} != the trained params")
        rep["ckpt_leaves"] = len(keys)
        del like, tree, trained
    gc.collect()
    torch.cuda.empty_cache()
    call = seen["flash_attention_bwd"]
    check(call[0].dtype == torch.bfloat16,
          f"train CLI: the flash backward ran on {call[0].dtype}")
    rep["bwd_vs_float64"] = bwd_against_float64(ops, *call)
    rep["bwd_bitwise_repeat"] = bwd_repeat_bitwise(ops, *call)
    q, k, v, _, kw = call
    seen["flash_attention"] = (q, k, v, kw)   # the forward at the same call
    rep["fwd_vs_float64"] = fwd_against_float64(ops, q, k, v, kw)
    rep["fwd_bitwise_repeat"] = fwd_repeat_bitwise(ops, q, k, v, kw)
    hold_and_time(seen, {name: sum(c[name] for c in launches)
                         for name in ("flash_attention",
                                      "flash_attention_bwd")},
                  model=f"{cfg.name} (train CLI)")
    del seen, call
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def serve_cli_runs(ops):
    """(b) ``repro_torch.launch.serve.main`` in-process at the CLI's own
    reduced sizes (``SERVE_RUNS``), launch counts set to 0 before each
    run and read after it. An offload run is one ``OffloadServer``
    request: every known token (the 8-token prompt, then each of the
    ``--tokens`` new ones, the last included, as ``generate`` does) is
    one engine step (``max_batch`` 1, per-token prefill); each step runs
    each layer's paged attention once and its MoE once, a batch-1 union
    of top-2 experts, which 4 slots hold in one chunk: one ``moe_ffn``.
    So (8 + tokens) x layers launches of each. Device mode (a dense
    ``ServingEngine``) launches none. Then one subprocess ``python -m
    repro_torch.launch.serve`` (``PYTHONPATH=src``): exit 0, ``hit_rate``
    printed, and the in-process run's tokens."""
    import torch
    from repro_torch.launch import serve as serve_cli

    rep = {}
    for name, argv in SERVE_RUNS:
        offload = "--mode" not in argv
        layers = int(argv[argv.index("--layers") + 1]) if offload else 0
        new = int(argv[argv.index("--tokens") + 1]) if offload else 0
        steps = SERVE_PROMPT_LEN + new
        want = ({"moe_ffn": steps * layers, "paged_attention": steps * layers}
                if offload else {})
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, text = captured(serve_cli.main, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        check_launches(launches, want, f"serve CLI {name}")
        tokens = [line for line in text.splitlines()
                  if line.startswith("tokens:")]
        check(len(tokens) == (1 if offload else 2),
              f"serve CLI {name} printed {text!r}")
        if offload:
            check(re.search(rf"^\s+decode_steps\s+{steps}$", text, re.M)
                  is not None and re.search(r"^\s+hit_rate\s", text, re.M)
                  is not None, f"serve CLI {name}: stats {text!r}")
        rep[name] = {"argv": argv, "seconds": seconds, "launches": launches,
                     "tokens": tokens}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *LAUNCH_SERVE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0 and "hit_rate" in r.stdout,
          f"python -m repro_torch.launch.serve: exit {r.returncode}\n"
          f"{r.stderr[-3000:]}")
    tokens = [line for line in r.stdout.splitlines()
              if line.startswith("tokens:")]
    check(tokens == rep["lfu_spec"]["tokens"],
          f"subprocess tokens {tokens} != in-process "
          f"{rep['lfu_spec']['tokens']}")
    rep["subprocess"] = {"seconds": time.perf_counter() - t0,
                         "tokens_equal_in_process": True}
    return rep


def pipeline_run(ops, card, hold_and_time):
    """(c) The paper's pipeline (``repro_torch.examples.
    offload_paper_pipeline``) at Mixtral-8x7B's full widths, 2 of 32
    layers, fp32. Stage 1: ``train_model`` (dense MoE path, batch 8 x 64,
    ``PIPELINE_LR``, ``PIPELINE_STEPS`` steps): each step launches the flash
    forward twice and its backward once per layer and nothing else,
    losses finite and the last below the first. The optimizer state goes
    with ``train``'s return; the trained params stay on the card. Then
    the expert masters are pinned once and shared by every engine
    (``reusing``), and stages 2-5 run as the reference script runs them
    (its 3 prompts of 4 tokens, 24 new tokens, 4 slots a layer), then the
    deployed engine's configuration with overlap off (the measured
    overlap comparison). Every engine decodes 3 x (4 + 24) batch-1 steps
    (``generate`` feeds each known token, the last new one included) and
    each step calls ``_grouped_ffn`` once a layer (a top-2 union in 4
    slots is one chunk): 168 ``moe_ffn`` launches an engine and nothing
    else. Checks: the same greedy tokens from every engine; spec P == R;
    each engine's H2D bytes == (misses + prefetches) x the stored bytes
    of one expert; the overlap engine's installs on its copy stream and
    its ``stats()`` off the clock keys equal the overlap-off engine's.
    Holds ``moe_ffn`` against its plain version at the stages' call.
    Returns the ``pipeline`` report: the card's decode step times beside
    the simulated A6000 clock (``CostModel``) of each engine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import HardwareProfile
    from repro_torch.core.expert_store import ExpertStore
    from repro_torch.core.offload_engine import OffloadEngine
    from repro_torch.examples import offload_paper_pipeline as pipe
    from repro_torch.training.tree import leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=PIPELINE_LAYERS, dtype="float32")
    L = cfg.num_layers
    B, S = 8, 64
    stamps, launches, kept = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    with patched(pipe, "train", counted_steps(
            {"flash_attention": 2 * L, "flash_attention_bwd": L},
            "pipeline", stamps, launches, kept)):
        params, losses = pipe.train_model(cfg, steps=PIPELINE_STEPS,
                                          batch=B, seq=S, lr=PIPELINE_LR,
                                          seed=SEED, device="cuda")
    kept.clear()
    check(len(losses) == PIPELINE_STEPS and all(np.isfinite(losses)),
          f"pipeline losses {losses}")
    check(losses[-1] < losses[0], f"pipeline loss did not fall: {losses}")
    check(not any(t.requires_grad for t in leaves(params)),
          "trained params require grad")
    train_rep = {"steps": PIPELINE_STEPS, "batch": B, "seq": S,
                 "lr": PIPELINE_LR,
                 "moe_path": "dense", "losses": losses,
                 "loss_first": losses[0], "loss_last": losses[-1],
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 **step_summary(stamps, B * S)}
    gc.collect()
    torch.cuda.empty_cache()

    need = sum(t.numel() * 4 for k, t in params["layers"]["moe"][
        "experts"].items())
    avail = mem_available()
    check(avail > need + (8 << 30),
          f"MemAvailable {avail} B: too little to pin {need} B of masters")
    t0 = time.perf_counter()
    store = ExpertStore.from_params(params, cfg, quant="none", pin=True)
    pin_s = time.perf_counter() - t0
    eb = store.expert_nbytes((0, 0))
    sized = (params, cfg, pipe.PROMPTS, pipe.NEW, pipe.SLOTS)
    per_engine = len(pipe.PROMPTS) * (len(pipe.PROMPTS[0]) + pipe.NEW) * L
    runs, streams, seen, stage_launches = [], [], {}, {}
    specs = {"moe_ffn": (lambda x_e, *_: x_e.shape[0] * x_e.shape[1],
                         lambda x_e, w1, w3, w2, slots: (
                             x_e.clone(), w1, w3, w2, list(slots)))}

    def stage(name, fn, engines):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        stage_launches[name] = ops.launch_counts()
        check_launches(stage_launches[name], {"moe_ffn": engines * per_engine},
                       f"pipeline {name}")
        return out

    def off():   # the deployed configuration with overlap off
        eng = OffloadEngine(params, cfg, cache_slots=pipe.SLOTS,
                            policy="lfu", prefetch="spec",
                            hw=HardwareProfile.a6000_pcie4(), device="cuda")
        return {"tokens": [eng.generate(p, pipe.NEW) for p in pipe.PROMPTS],
                "stats": pipe.plain_values(eng.stats())}

    t_stages = time.perf_counter()
    with reusing(store), patched(OffloadEngine, "decode_tokens",
                                 timed_decode(runs)), \
            recording(ops, seen, specs):
        trace = stage("lru_trace", lambda: pipe.lru_trace(
            *sized, device="cuda"), 1)
        table = stage("compare_policies", lambda: pipe.compare_policies(
            *sized, device="cuda"), len(pipe.POLICIES))
        spec = stage("speculative", lambda: pipe.speculative(
            *sized, device="cuda"), 1)
        with install_streams(streams):
            dep = stage("deployed", lambda: pipe.deployed(
                *sized, device="cuda"), 1)
        dep_off = stage("deployed_overlap_off", off, 1)
    stages_s = time.perf_counter() - t_stages
    named = ([("lru_trace", trace)]
             + [(p, table[p]) for p in pipe.POLICIES]
             + [("speculative", spec), ("deployed", dep),
                ("deployed_overlap_off", dep_off)])
    check(len(runs) == len(named) and all(
        len(r) == per_engine // L for r in runs),
        f"decode steps an engine: {[len(r) for r in runs]}")
    for name, r in named:
        check(r["tokens"] == trace["tokens"],
              f"pipeline {name}: tokens {r['tokens']} != the LRU run's "
              f"{trace['tokens']}")
    s_spec = spec["stats"]
    check(abs(s_spec["spec_precision"] - s_spec["spec_recall"]) < 1e-9,
          f"spec P {s_spec['spec_precision']} != R {s_spec['spec_recall']}")
    for name, r in named[1:]:
        s = r["stats"]
        check(s["bytes_transferred"] == (s["misses"] + s["prefetches"]) * eb,
              f"pipeline {name}: {s['bytes_transferred']} H2D bytes, "
              f"(misses + prefetches) x {eb} = "
              f"{(s['misses'] + s['prefetches']) * eb}")
    # (`None != stream` is False in PyTorch: test `is None` first)
    check(bool(streams) and all(c is not None and c == q == streams[0][0]
                                for c, q in streams),
          "deployed: installs not on the engine's copy stream")
    for k, v in dep_off["stats"].items():
        check(k in CLOCK_KEYS or dep["stats"][k] == v,
              f"deployed: stats()[{k}] overlap on {dep['stats'][k]} != "
              f"off {v}")

    def card_ms(ms):   # one token a decode step (batch 1)
        med = sorted(ms)[len(ms) // 2]
        return {"median_step_ms": med, "mean_step_ms": sum(ms) / len(ms),
                "max_step_ms": max(ms), "tokens_per_s": 1e3 / med,
                "run_tokens_per_s": len(ms) / sum(ms) * 1e3,
                "decode_steps": len(ms)}

    def row(r, ms):
        s = r["stats"]
        return {"hit_rate": s["hit_rate"],
                "cache_precision": s["cache_precision"],
                "cache_recall": s["cache_recall"],
                "sim_tokens_per_s": s["sim_tokens_per_s"],
                "sim_clock": "costmodel_a6000",
                "h2d_bytes": s["bytes_transferred"],
                "misses": s["misses"], "prefetches": s["prefetches"],
                **card_ms(ms)}

    rows = {name: row(r, ms) for (name, r), ms in zip(named, runs)}
    hold_and_time({k: v[1] for k, v in seen.items()},
                  {"moe_ffn": sum(c["moe_ffn"]
                                  for c in stage_launches.values())},
                  model=f"{cfg.name} (pipeline, trained, 2 layers)")
    del seen, store, params
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "card": card, "model": cfg.name, "layers": L,
        "widths": {"d_model": cfg.d_model, "heads": cfg.num_heads,
                   "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
                   "experts": cfg.num_experts,
                   "top_k": cfg.num_experts_per_tok,
                   "expert_d_ff": cfg.expert_d_ff, "vocab": cfg.vocab_size},
        "reduced": {"layers": f"{L} of 32",
                    "train_steps": f"{PIPELINE_STEPS} of 100",
                    "lr": f"{PIPELINE_LR} (the reference's 2e-3 diverges "
                          f"at d_model 4096)"},
        "train": train_rep, "pin_s": pin_s, "expert_bytes": eb,
        "stages_s": stages_s,
        "temporal_locality": trace["temporal_locality"],
        "random_locality": trace["random_locality"],
        "histograms": trace["histograms"], "render": trace["render"],
        "tokens": trace["tokens"],
        "policies": {p: rows[p] for p in pipe.POLICIES},
        "lru_trace": rows["lru_trace"],
        "speculative": {"spec_precision": s_spec["spec_precision"],
                        "spec_recall": s_spec["spec_recall"],
                        **rows["speculative"]},
        "overlap": {"on": rows["deployed"],
                    "off_same_policy": rows["deployed_overlap_off"],
                    "reference_compare": "deployed (lfu+spec+overlap) vs "
                                         "speculative (lru+spec)",
                    "exposed_transfer_frac_on":
                        dep["stats"]["exposed_transfer_frac"],
                    "exposed_transfer_frac_off":
                        dep_off["stats"]["exposed_transfer_frac"]},
        "launches": stage_launches,
        "phase_s": time.perf_counter() - t_phase}


def examples_runs(ops):
    """(d) ``quickstart.main`` and ``serve_batch.main`` at their own
    sizes, launch counts set to 0 before each and read after.
    quickstart: 80 train steps (4 layers: the flash forward 8 and its
    backward 4 a step), then an LRU and an LFU ``OffloadServer`` of 4 + 24
    steps, each a paged attention and a ``moe_ffn`` a layer; its LRU and
    LFU tokens must be equal. serve_batch: the dense engine launches
    nothing; the solo server (3 layers) (3 + 8) + (4 + 8) + (1 + 8) steps;
    the continuous server its ``decode_steps`` (a union of two rows' top-2
    fits its 4 slots: one ``moe_ffn`` a layer); its outputs must equal the
    solo server's."""
    import torch
    from repro_torch.examples import quickstart, serve_batch

    rep = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    qs, text = captured(quickstart.main, [])
    torch.cuda.synchronize()
    served = qs["served"]
    check(served["lru"]["tokens"] == served["lfu"]["tokens"],
          f"quickstart: LRU {served['lru']['tokens']} != LFU "
          f"{served['lfu']['tokens']}")
    serving = 2 * (len(quickstart.PROMPT) + 24) * 4
    check_launches(ops.launch_counts(), {
        "flash_attention": 80 * 8, "flash_attention_bwd": 80 * 4,
        "moe_ffn": serving, "paged_attention": serving}, "quickstart")
    rep["quickstart"] = {
        "seconds": time.perf_counter() - t0, "launches": ops.launch_counts(),
        "loss_first": qs["losses"][0], "loss_last": qs["losses"][-1],
        "tokens": served["lru"]["tokens"],
        "hit_rate": {p: r["stats"]["hit_rate"] for p, r in served.items()}}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sb, text = captured(serve_batch.main, [])
    torch.cuda.synchronize()
    cont, solo = sb["continuous"], sb["solo"]
    check(cont["outs"] == solo["outs"],
          f"serve_batch: continuous {cont['outs']} != solo {solo['outs']}")
    steps = sum(len(p) + serve_batch.NEW for p in serve_batch.PROMPTS)
    check(solo["stats"]["decode_steps"] == steps,
          f"serve_batch: solo {solo['stats']['decode_steps']} steps")
    n = 3 * (steps + cont["stats"]["decode_steps"])
    check_launches(ops.launch_counts(), {"moe_ffn": n, "paged_attention": n},
                   "serve_batch")
    rep["serve_batch"] = {
        "seconds": time.perf_counter() - t0, "launches": ops.launch_counts(),
        "outs": solo["outs"], "dense": sb["dense"],
        "continuous_steps": cont["stats"]["decode_steps"]}
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def launch_phase(ops, card, hold_and_time):
    """7c: the port's entry points as a user calls them: the train CLI
    (``train_cli_run``), the serve CLI in-process and as ``python -m``
    (``serve_cli_runs``), the paper's pipeline at full widths
    (``pipeline_run``) and the two other examples (``examples_runs``).
    Returns (the ``pipeline`` report, the rest)."""
    t0 = time.perf_counter()
    rep = {"card": card, "train_cli": train_cli_run(ops, card, hold_and_time),
           "serve_cli": serve_cli_runs(ops)}
    pipeline = pipeline_run(ops, card, hold_and_time)
    rep["examples"] = examples_runs(ops)
    rep["phase_s"] = time.perf_counter() - t0
    return pipeline, rep


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the serving loop and one prefill of "
                             "each model with torch.profiler")
    args = parser.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        sys.exit("chip_smoke.py: no src/repro_torch beside this script; "
                 "run it from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this script needs a CUDA GPU")
    import numpy as np
    from torch.autograd import DeviceType

    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(SRC),
          f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    from repro_torch.configs import get_config
    from repro_torch.core.learned import train_from_trace
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.offload_serving import ContinuousOffloadServer

    # fp32 products in full fp32 (no TF32), the plain versions' precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    built = ops.build_kernels()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "compiled": sorted(built)}), flush=True)
    for name, rep in built.items():
        for line in rep["ptxas"].splitlines():
            if "registers" in line:
                print(f"ptxas {name}: {line.strip()}")
    # registers, smem, spills
    for name in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                 "ssd_chunk_bwd"):
        if name in built:
            print(json.dumps({"ptxas": {name: [
                line.strip() for line in built[name]["ptxas"].splitlines()
                if line.strip()]}}), flush=True)
    bwd_kernels = ops.ptxas_kernels(ops.build_log("flash_attention_bwd"))
    print(json.dumps({"ptxas_kernels": {"flash_attention_bwd": bwd_kernels}}),
          flush=True)
    no_spill = flash_mod.BACKWARD.NO_SPILL
    kept = [r for r in bwd_kernels if r["kernel"] in no_spill]
    check(len(kept) == len(no_spill)
          and not any(r["stack"] or r["spill_stores"] or r["spill_loads"]
                      for r in kept),
          f"flash backward kernels spill or are missing: {kept}")
    fwd_kernels = ops.ptxas_kernels(ops.build_log("flash_attention"))
    print(json.dumps({"ptxas_kernels": {"flash_attention": fwd_kernels}}),
          flush=True)
    no_spill = flash_mod.FORWARD_NO_SPILL
    kept = [r for r in fwd_kernels if r["kernel"] in no_spill]
    check(len(kept) == len(no_spill)
          and not any(r["stack"] or r["spill_stores"] or r["spill_loads"]
                      for r in kept),
          f"tile flash forward kernels spill or are missing: {kept}")
    no_spill = flash_mod.ONE_QUERY_NO_SPILL
    kept = [r for r in fwd_kernels if r["kernel"] in no_spill]
    check(len(kept) == len(no_spill)
          and not any(r["stack"] or r["spill_stores"] or r["spill_loads"]
                      for r in kept),
          f"one-query flash forward kernels spill or are missing: {kept}")
    # the tile forward (fp32 and bf16) and the backward (fp32 and bf16)
    # run warpgroup MMAs (HGMMA) and no mma.sync (HMMA)
    sass = ops.sass_counts("flash_attention")
    print(json.dumps({"sass_mma_counts": {"flash_attention": sass}}),
          flush=True)
    for kind in ("flash_fwd_bf16<", "flash_fwd_f32<"):
        tile = [c for k, c in sass.items() if k.startswith(kind)]
        check(len(tile) == 4 and all(c["HGMMA"] > 0 and c["HMMA"] == 0
                                     for c in tile),
              f"{kind[:-1]} SASS: {sass}")
    check(not any(k.startswith("flash_attention_kernel") for k in sass),
          f"a mma.sync flash forward kernel is left: {sass}")
    sass = ops.sass_counts("flash_attention_bwd")
    print(json.dumps({"sass_mma_counts": {"flash_attention_bwd": sass}}),
          flush=True)
    # every backward kernel, fp32 and bf16: warpgroup MMAs, no mma.sync
    bwd = {k: c for k, c in sass.items() if k.startswith("flash_bwd_")}
    check(len(bwd) == 16
          and {k.split("<")[0] for k in bwd} == {
              "flash_bwd_rows_f32", "flash_bwd_keys_f32",
              "flash_bwd_rows_bf16", "flash_bwd_keys_bf16"}
          and all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in bwd.values()),
          f"flash backward SASS: {sass}")

    # ---- the model at full widths, 2 layers, and the server ---------
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2,
                              dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    server_kw = dict(cache_slots=4, policy="lfu", prefetch="spec",
                     max_batch=4, kv_block_size=16,
                     cache_len=PROMPT_LEN + NEW_TOKENS, device="cuda")
    srv = ContinuousOffloadServer(params, cfg, **server_kw)
    torch.cuda.synchronize()
    store = srv.engine.store
    pinned = all(v.is_pinned() and s is None for k in store.keys()
                 for v, s in store.payload(k).values())
    check(pinned, "expert masters are not in pinned host memory")
    print(json.dumps({
        "setup_s": time.perf_counter() - t0,
        "expert_master_bytes": store.total_nbytes(),
        "expert_slot_bytes": sum(c.device_nbytes()
                                 for c in srv.engine.caches),
        "device_bytes_allocated": torch.cuda.memory_allocated()}),
        flush=True)

    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in SUBMIT_AT_STEP]

    # ---- serve ------------------------------------------------------
    def profiler():
        act = torch.profiler.ProfilerActivity
        return (torch.profiler.profile(activities=[act.CPU, act.CUDA])
                if args.profile else None)

    prof = profiler()
    rids, launches, step_ms, step_h2d, calls, loop_ms = serve(
        srv, prompts, ops, prof)
    print(json.dumps({"steps": len(step_ms), "step_ms": step_ms,
                      "h2d_expert_bytes": step_h2d,
                      "h2d_equals_trace": True,
                      "launches": launches}), flush=True)
    if prof is not None:
        print(json.dumps({"profile": device_time_summary(
            prof, loop_ms, sum(step_h2d))}), flush=True)
    off = served_run(srv, rids, step_ms, step_h2d, loop_ms, launches)
    # the learned phase's model: this serving run's trace, nothing else
    model = train_from_trace(srv.trace, cfg.num_experts)

    # ---- the same run with the installs on the copy stream ----------
    print(json.dumps({"overlap_serving": overlap_run(
        params, cfg, prompts, ops, server_kw, store, srv, off,
        profiler())[0]}), flush=True)

    # ---- outputs: finite logits, server tokens == generate tokens ---
    logits = srv._logits
    check(tuple(logits.shape) == (srv.max_batch, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    served = [srv.result(r) for r in rids]
    t0 = time.perf_counter()
    for p, out in zip(prompts, served):
        want = srv.engine.generate(p, NEW_TOKENS)
        check(out == want, f"server {out[PROMPT_LEN:]} != generate "
                           f"{want[PROMPT_LEN:]} for prompt {p}")
    print(json.dumps({"server_equals_generate": True,
                      "generate_s": time.perf_counter() - t0,
                      "new_tokens": [o[PROMPT_LEN:] for o in served]}),
          flush=True)

    # ---- each kernel against its plain version ----------------------
    # (each run's launches were read when it ended: these do not count)
    kernels = []
    one = torch.zeros(1, device="cuda")
    # a one-element op in the same 20-launch graph harness: what a launch
    # costs, beside each kernel's time and bound
    floor_ms = device_ms(lambda: one.add_(1), 20, graph=True)

    def hold_and_time(calls, launches_by_kernel, model=None):
        """Hold and time each kernel of ``calls`` (``kernel_cases``); its
        record goes into the ``kernels`` line with the main path's
        launches, or, with ``launches_by_kernel`` None (a call off the
        path), onto a ``kernel_off_path`` line only. Returns the records."""
        recs = []
        for (name, kern, plain, library, graph, nbytes, flops, shape,
             library_bwd) in kernel_cases(calls):
            bf16 = shape.get("dtype") == "torch.bfloat16"
            tol = BF16_TOL if bf16 else TOL[name]
            err, rel = agree(name, kern(), plain(), tol, name)
            iters = 20 if graph else 10
            ms = device_ms(kern, iters, graph=graph)
            plain_ms = device_ms(plain, iters, graph=graph)
            library_ms = (device_ms(library, iters, graph=graph)
                          if library is not None else None)
            # the flash forward's one-query route runs fp32 FMAs
            peak, rate = (FP32_PEAK if shape.get("path") == "one_query"
                          else BF16_PEAK if bf16
                          else PEAK.get(name, FP32_PEAK))
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
            bound_ms = max(t_bytes, t_ops) * 1e3
            rec = {
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": (None if launches_by_kernel is None
                             else launches_by_kernel[name]),
                "max_abs_err": err,
                "max_err_over_max_plain": rel, "tol": tol,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "launch_floor_ms": floor_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bound_peak": f"{peak}, {rate / 1e12:g} TFLOP/s",
                "share_of_bound": bound_ms / ms,
                "library_ms": library_ms, "bytes": nbytes, "flops": flops,
                "shape": shape}
            if model is not None:   # the entries of a later model's phase
                rec["model"] = model
            if library_bwd is not None:
                rec["library_bwd_ms"] = device_ms(library_bwd, iters,
                                                  graph=graph)
            if name in PEAK:   # the fp32-core bound, and the passes
                rec["bound_fp32_ms"] = max(
                    t_bytes, flops / FP32_FLOPS_PER_S) * 1e3
                passes, pass_rate = pass_flops(name, shape, flops)
                rec["bound_passes_ms"] = max(t_bytes,
                                             passes / pass_rate) * 1e3
            if args.profile and library is not None:
                # name the kernels the library call ran
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                library()
                torch.cuda.synchronize()
                prof.stop()
                rec["library_kernels"] = sorted(
                    {ev.name[:100] for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA})
            recs.append(rec)
            if launches_by_kernel is None:
                print(json.dumps({"kernel_off_path": rec}), flush=True)
            else:
                kernels.append(rec)
                print(json.dumps({"kernel": rec}), flush=True)
        return recs

    hold_and_time(calls, launches)
    print(json.dumps({"paged_split_sweep": paged_split_sweep(calls,
                                                             floor_ms)}),
          flush=True)
    del srv, calls
    gc.collect()

    # ---- int8 expert masters: overlap off, on, the learned policy ---
    rep, on_rep, learned_rep, tier_rep = int8_serving(
        params, cfg, prompts, ops, server_kw, model, profiler, card)
    print(json.dumps({"int8_serving": rep}), flush=True)
    print(json.dumps({"overlap_serving": on_rep}), flush=True)
    print(json.dumps({"learned_serving": learned_rep}), flush=True)
    print(json.dumps({"tiers": tier_rep}), flush=True)
    gc.collect()

    # ---- the offload invariants and race checks on the card ---------
    print(json.dumps(offload_invariants(params, cfg, prompts, store)),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- full-sequence prefill and ServingEngine: Mixtral -----------
    seen = {}
    flash_launches, rep = prefill_phase(params, cfg, ops, seen,
                                        args.profile)
    print(json.dumps({"prefill": rep}), flush=True)

    # ---- the dry run's counter on the card, and two dry-run cases ---
    print(json.dumps({"dryrun": dryrun_phase(params, cfg, ops, card)}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the distributed paths at world size 1 (NCCL) ---------------
    import torch.distributed as dist
    mesh = open_mesh()
    try:
        t0 = time.perf_counter()
        ep = ep_check(params, cfg, mesh)
        ep["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_seen = {}
        tp = tp_prefill_check(params, cfg, mesh, ops, tp_seen)
        hold_and_time({"flash_attention": tp_seen["flash_attention"][1]},
                      {"flash_attention": tp["launches"]["flash_attention"]},
                      model=f"{cfg.name} tensor-parallel (1x1 mesh)")
        tp["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serving = offload_mesh_check(params, cfg, prompts, store, mesh, ops,
                                     server_kw, hold_and_time, card)
        serving["s"] = time.perf_counter() - t0
        print(json.dumps({"mesh_serving": serving}), flush=True)
        tier_mesh = tier_mesh_check(params, cfg, store, mesh, ops,
                                    hold_and_time, card)
        print(json.dumps({"tier_mesh_serving": tier_mesh}), flush=True)
        del params, tp_seen, store
        gc.collect()
        torch.cuda.empty_cache()

        # ---- DeepSeek-V2: offload serving, prefill, MLA decode ------
        ds_serving, ds_prefill, mla = deepseek_phase(
            ops, card, hold_and_time, args.profile, mesh)
        print(json.dumps({"deepseek_serving": ds_serving}), flush=True)
        print(json.dumps({"prefill": ds_prefill}), flush=True)

        # ---- the hybrid, encdec and vlm families: prefill and engine;
        # Jamba's prefill again under the mesh ------------------------
        hybrid, cross = None, {}
        for arch in ("jamba-1.5-large-398b", "whisper-tiny",
                     "llama-3.2-vision-11b"):
            rep = family_phase(arch, ops, card, hold_and_time, args.profile,
                               mesh)
            hybrid = rep.get("mesh_prefill", hybrid)
            if "mesh_cross" in rep:
                cross[arch] = rep["mesh_cross"]
            print(json.dumps({"prefill": rep}), flush=True)
            if arch in BF16_ENGINES:
                # the phase again in the config's own bf16 (no mesh): every
                # engine cross call on the one-query route's bf16 kernel
                rep = family_phase(arch, ops, card, hold_and_time,
                                   args.profile,
                                   dtype=get_config(arch).dtype)
                print(json.dumps({"bf16_engine": rep}), flush=True)

        # ---- the same for Mamba2, then its SSM split by head --------
        mcfg = dataclasses.replace(get_config("mamba2-2.7b"),
                                   num_layers=MAMBA_LAYERS, dtype="float32")
        mparams = init_params(
            mcfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        ssd_launches, rep = prefill_phase(mparams, mcfg, ops, seen,
                                          args.profile)
        print(json.dumps({"prefill": rep}), flush=True)
        t0 = time.perf_counter()
        ssm_seen = {}
        ssm = ssm_mesh_check(mparams, mcfg, mesh, ops, ssm_seen)
        hold_and_time({"ssd_chunk": ssm_seen["ssd_chunk"][1]},
                      {"ssd_chunk": ssm["launches"]["ssd_chunk"]},
                      model=f"{mcfg.name} head-split SSM (1x1 mesh)")
        ssm["s"] = time.perf_counter() - t0
        del mparams, ssm_seen
        gc.collect()
        torch.cuda.empty_cache()

        # ---- train steps under the mesh against plain ones ----------
        train = {}
        for run in MESH_TRAIN_RUNS:
            t_seen = {}
            rep = mesh_train_check(*run, mesh, ops, t_seen)
            hold_and_time(t_seen, {k: rep["launches_mesh_steps"][k]
                                   for k in t_seen},
                          model=f"{rep['model']} train step (1x1 mesh)")
            train[rep["model"]] = rep
            print(json.dumps({"mesh_train": rep, "card": card}), flush=True)
            del t_seen
            gc.collect()
            torch.cuda.empty_cache()
        zero1 = {}
        for run in ZERO1_TRAIN_RUNS:
            t_seen = {}
            rep = zero1_train_check(*run, mesh, ops, t_seen)
            if rep["dtype"] == "bfloat16" and "flash_attention" in t_seen:
                q, k, v, kw = t_seen["flash_attention"]
                rep["fwd_vs_float64"] = fwd_against_float64(ops, q, k, v,
                                                            kw)
                rep["fwd_bitwise_repeat"] = fwd_repeat_bitwise(ops, q, k, v,
                                                               kw)
            if t_seen:
                hold_and_time(t_seen, {k: rep["launches_mesh_steps"][k]
                                       for k in t_seen},
                              model=f"{rep['model']} ZeRO-1 train step "
                                    f"(1x1 mesh)")
            zero1[rep["model"]] = rep
            print(json.dumps({"zero1_train": rep, "card": card}),
                  flush=True)
            del t_seen
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({"distributed": {
            "world_size": dist.get_world_size(), "backend": "nccl",
            "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
            "mesh": {"data": 1, "model": 1}, "ep_moe": ep,
            "tp_prefill": tp, "mla_decode": mla, "hybrid_prefill": hybrid,
            "ssm": ssm, "encdec": cross["whisper-tiny"],
            "vlm": cross["llama-3.2-vision-11b"], "train": train,
            "zero1_train": zero1, "offload_serving": serving,
            "tier_serving": tier_mesh, "mla_serving": ds_serving["mesh"],
            "phase_s": ep["s"] + tp["s"] + serving["s"] + tier_mesh["seconds"]
            + ds_serving["mesh"]["s"] + mla["s"] + hybrid["s"] + ssm["s"]
            + sum(c["s"] for c in cross.values())
            + sum(t["s"] for t in train.values())
            + sum(z["s"] for z in zero1.values()), "card": card}}),
            flush=True)
    finally:
        dist.destroy_process_group()

    # ---- training: Qwen1.5-0.5B whole, Mixtral-8x7B (2 layers) -------
    print(json.dumps({"training": training_phase(
        ops, card, hold_and_time, args.profile)}), flush=True)

    # ---- the CLIs, the paper's pipeline and the examples ------------
    pipeline, rep = launch_phase(ops, card, hold_and_time)
    print(json.dumps({"pipeline": pipeline}), flush=True)
    print(json.dumps({"launch": rep}), flush=True)

    hold_and_time({k: v[1] for k, v in seen.items()},
                  {"flash_attention": flash_launches["flash_attention"],
                   "ssd_chunk": ssd_launches["ssd_chunk"]})
    print(json.dumps({"coverage": coverage_checks()}), flush=True)
    print(json.dumps(paged_batch_independence()), flush=True)
    cross, bf16_cross = one_query_cross(floor_ms)
    print(json.dumps({"one_query_cross": cross,
                      "bf16_one_query": bf16_cross, "card": card}),
          flush=True)
    print(json.dumps(one_query_independence()), flush=True)
    for dt in ("float32", "bfloat16"):
        print(json.dumps({"one_query_sweep": one_query_sweep(floor_ms, dt),
                          "card": card}), flush=True)
    print(json.dumps({"wall_s": time.perf_counter() - t_start}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
