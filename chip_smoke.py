#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acco_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name, the device count, nvidia-smi's name and
   power limit;
2. build: compiles csrc/fused_attention.cu (K1), banded_attention.cu
   (K2), fused_ce.cu (K3, with hopper_gemm.cuh), flash_attention.cu (K5)
   and block_attention.cu (K4; the bf16 kernels of K1, K2, K4 and K5 on
   the attention mainloop of hopper_attention.cuh) for sm_90a from the
   checkout (into build/),
   one nvcc each, started together, and prints each nvcc's time and
   ptxas's report (registers, spills, its notes on wgmma);
3. parity: each kernel against its plain PyTorch version on the same
   inputs on the card, bf16 unless named, and each attention backward
   kernel (K1, K2, K4, K5) against a second run of itself, which must
   give the same bits. 'auto' at head_dim 128, L 512 must resolve to K1. K1 at
   the Llama flagship shape (B 8, H = Hkv 12, L 1024, D 64, window 0, no
   pad), at a small GQA shape with window 256 and a key pad mask, at
   GPT-Neo's global shape (scale 1.0), at Llama-3-8B's width as phase
   15's stage runs it (B 4, H 32, Hkv 8, L 512, D 128), with left padding (rows with no allowed key;
   also with a window 16 wide and a run of pads, at L 320, a half tile),
   at L 320 with GQA and D 64, and in float32 at D 128; K2 at GPT-Neo's
   local shape (W 256, scale 1.0), a small odd window (W 129), the widest
   band of its envelope (W 897), GPT-Neo-2.7B's local layer (H 20, D
   128, L 2048, W 256) and an odd window at D 128; 'fused' GPT-Neo at
   head_dim 128 must send its local layer to K2 and agree with the plain
   path;
   K3 (the fused lm-head + CE: forward, dp, dH, dW, the four on the
   wgmma/TMA mainloop of hopper_gemm.cuh; dp held exactly, up to one bf16
   step at a rounding edge; dp, dH and dW run twice must give the same
   bits) at Llama-125M's head (8184 rows, D 768, V 50257), a small
   unaligned shape (64 rows, D 128, V 277, real vocab 256, ignored rows,
   smoothing 0.1) and Llama-3-8B's head at phase 15's stage (2048 rows,
   the last of each 512 ignored, D 4096, V 128256),
   the two heads also with the softmax term alone in dlogits, and its
   backward in 3 chunks of rows (dW summed in float32) at the
   Llama-125M head against the one-chunk dH and the plain chunked dW;
   the head's
   float32 logits against the
   widened product; K5 (causal flash attention with segment ids) at the
   Llama flagship shape, a small GQA shape with pads in the middle and at
   the tail (D 128; also in float32, and at L 320), Llama-3-8B's
   long-context shape (B 1, H 32, Hkv 8, L 8192, D 128) and L 320 at D
   64; K4 (the ring's block: forward, row
   pre-pass, dK/dV, dQ, with random cotangents on o, m and l) at (a) the
   Llama-350M preset's block at sp 16 (B 1, H 16, L 1024, D 64), (b)
   Llama-3-8B at the ring path's half-chunk (H 32, Hkv 8, L 4096, D 128),
   both full and diagonal, (c) GPT-Neo-125M's positional block at a
   zig-zag hop at sp 2 (windows 0 and 256, rows fully masked), (d) small
   cases with ties planted at the row max (float32 and bf16, dm != 0,
   every mode), a small bf16 GQA case and (e) Lq 192 != Lk 320 (half
   tiles); then K3's (one fault in each of its four passes), K5's, K1's
   (the mask policy, dK/dV, dQ, the RS fragments of
   hopper_attention.cuh), K2's (a band one tile short) and K4's (its
   statistics, the tie term, dl, the window, the positional walk, the
   sum of V on a row with no key, Lq and Lk swapped) bars against planted
   faults, each in a patched copy of the kernel's source, which they
   must fail (each built and checked in its own process from the end of
   phase 2 on, beside the parity checks and phase 6, which runs before
   phase 4);
4. timing: CUDA events over many launches after a warm-up, for each
   kernel, its plain version and, where one PyTorch call computes the
   same function, that call (F.scaled_dot_product_attention); K2 also
   beside K1 at the same window, and at GPT-Neo-2.7B's local layer; K3
   at the main path's head (8192 rows, D 768, V 50257) and at the
   long-context paths' head (8192 rows, D 4096, V 128256; before the
   paths, its 4.2 GB of float32 logits freed after) beside the port's
   materialized head and CE, which no single
   PyTorch call replaces; K1 also at Llama-3-8B's width (D 128, B 4 x L 512)
   beside SDPA; K5 at the flagship shape beside K1 and at the
   long-context shape; K4 at (a), (b) and (c), beside SDPA on the same
   attended pairs (the same work, not the same function: SDPA returns
   the normalised output and no row max or sum);
5. main paths: ``python -m acco_tpu_torch train=acco model=llama-125M
   data=synthetic``, ``... model=gptneo ...`` and ``... model=llama-125M
   ... train.fused_loss=pallas`` in-process at full width (12 layers,
   d 768, seq 1024, batch 8, n_acc 1), and ``... model=llama-125M
   model.config_path=<tmp>/llama-3-8B-depth2.json train.max_length=8192
   train.batch_size=1`` (Llama-3-8B at full width cut to 2 layers,
   'auto' attention resolving to K5 and 'auto' fused loss to K3), with
   no process group; then the ring paths, the last two paths' models on
   the ring of context parallelism through a one-rank NCCL sequence
   group handed to ``build_trainer`` (zig-zag: two diagonal half-blocks
   and one full a layer for Llama; the windowed ring's positional block
   a layer for GPT-Neo; the loss through K3, as 'auto' resolves under
   CP): the seed round and 6 rounds each, with the kernels' launch counts
   and the calls of the materialized head set to 0 just before each run
   and read just after, the ring paths' round-0 losses against their
   base paths' on the same weights and batch, and one GPT-Neo forward and
   backward through the windowed ring against the non-CP path (K1 + K2);
   then the dp paths, the Llama-125M path through the data-parallel code
   on the same one-rank NCCL group handed to ``build_trainer`` as its dp
   group (the count all-reduce and ZeRO-1's collectives on groups of
   their own) with ``train=acco``, ``train=dpu`` and ``train=ddp``, each
   first loss held to the Llama-125M path's. Every ACCO and DPU path runs
   its comm branch (the count, the sharded AdamW, the all-gather) on a
   CUDA stream of its own, under the compute branch. Every steady-state
   round of these paths runs as a CUDA graph captured before the first
   round and replayed (``acco_tpu_torch/compile/graphs.py``; the seed
   round runs once, uncaptured): the seed round and 8 rounds each, the
   launch counts credited by each replay with what its capture launched;
6. agreement: the entry point on a small float32 input through the
   kernels and through the plain attention gives the same losses and
   gradients (tiny128, then gpt-neo-125M at L 512), and so do
   ``train.fused_loss=pallas`` (K3) against the materialized CE,
   ``train.use_pallas_attention=true`` (K5) and the one-rank ring (K4)
   against the plain attention (tiny128); and the comm stream changes
   no bit: 6 float32 ACCO rounds of tiny128 through it equal the same
   rounds with the comm branch on the current stream, plainly and with a
   ~10 ms ``torch.cuda._sleep`` planted at the head of either branch,
   while with the end-of-round wait (or the start-of-round wait) removed
   and the sleep on the side it guards they must differ;
7. profile: each main and ring path again (the dp paths, the Llama-125M
   path's model and data, not since PR 18) with ``train.profile_steps`` over its
   steady rounds (the captures come before them), for the device time
   per kernel, K1's to K5's device time per microbatch, the device's
   idle share (the union of every stream's activity against phase 5's
   median round) and, from the trace's streams read by the package's
   reader (``acco_tpu_torch/telemetry/profile.py``: streams named by
   probe kernels, a replay's by the probes captured at the head of each
   branch), the comm side's device ms (the comm stream and NCCL's) and
   its overlap share, the part of it under compute-stream activity, with
   the prefetch copy stream on its own line, out of the comm side, and
   the host's launch calls and graph launches a round; then Llama-125M's
   rounds again with the comm branch on the current stream, for their
   median round ms beside phase 5's;
8. resume: Llama-125M at full width (``train=acco train.n_warmup_steps=2
   train.eval=true train.eval_step=4``, a constant LR, a temporary run
   dir, deleted after): run A to 10 grads, run B to 6 (mid-epoch, on an
   ACCO commit) with its final save, run C from B's checkpoint root to 10
   must equal A bit for bit (every state leaf, the round and eval
   losses), and two planted faults (the loader position dropped, the
   pending grads zeroed) must differ; a truncated ``rank_0.pt`` in a
   newer step must be skipped by ``latest_checkpoint``; the eval on A's
   params through K1 and K3's forward (``train.fused_loss=pallas``) must
   launch ``ce_fwd`` once and ``attn_fwd`` once a layer per batch and no
   backward kernel, and agree with the plain attention and materialized
   CE; ``acco_tpu_torch.perplexity_eval.compute`` on B's ``params.npz``
   through K1 against the plain attention; it prints the checkpoint's
   bytes, the save and restore ms, the eval's ms a batch and the
   perplexity beside nvidia-smi's line; then the logging cadence: the
   Llama-125M path and its fused-CE cell again, 20 rounds read back
   once every 10 grads (``train.delta_step_for_log=10``, the default),
   their mean round ms between the two boundaries beside phase 5's
   synced median. Phases 5-7 run with ``train.save=false``, their run
   dirs in a temporary directory, and read every round back
   (``delta_step_for_log=1``: a round's ms is its synced time, as
   PERF.md section 2 defines it); phase 8's runs A, B and C read back
   every 2 grads, where their evals fall. Phases 5-8 run with the
   prefetch on, the train config's default (phase 8's A/B/C at depth 2);
9. the input pipeline, remat and finetuning: (a) the cadence runs of
   phase 8 (d) again with ``train.prefetch=false``: their round losses
   and final params bit-equal to the prefetched runs', the mean round ms
   of rounds 11-20, the idle share from a profiled rerun (Llama-125M's)
   and the consumer's wait for its block, each prefetched and not; then
   the copy
   stream's ordering: a block whose copy sleeps ~0.4 s on the copy stream
   read right after the consumer takes it must equal the host block, and
   with the wait on the copy's event removed (a planted fault) the read
   must run first (events show the race taken; the sleep grows 4x if
   not) and differ; (b) resume with the prefetch on: phase 8 (a); (c)
   the long-context path with ``train.remat=dots`` (K5's forward once a
   layer, its O and LSE saved) and ``true`` (twice), their peak memory
   and median round beside phase 5's remat-off run; tiny128 in float32
   through K1 under each mode against remat off (the loss and
   gradients, and K1's forward launches), and 'dots+probs' on the plain
   path; (d) GPT-Neo-125M and Llama-125M at full width, random init from
   the seed, written as HF checkpoint directories (``config.json``,
   ``model.safetensors`` in HF's names, bf16, the tied head omitted) and
   finetuned through the entry point's trainer (``train=acco-ft``:
   truncated rows with pad masks, max_length 512, batch 4, n_acc 2, the
   eval on): the loaded flat vector bit-equal to the one written, K1's
   launches with a pad mask counted, each first loss equal to the same
   model's from the architecture file with ``params_from_jax`` of the
   written params; ``acco_tpu_torch.perplexity_eval --hf-checkpoint``
   through K1 against the plain attention; GPT-Neo-2.7B's preset (D 128,
   bf16, random init, forward only) through K1 + K2 against the plain
   path; (e) the native collate built with g++ and called on these paths;
10. a run that survives (Llama-125M at full width, ACCO unless named,
   through the entry point's trainer, K1's launches counted on every
   run): (a) 20 rounds read back every 10 grads with a save at every
   boundary, ``train.ckpt_async`` true and false, beside the same run
   without saves: the loop's stall a save (the async snapshot against
   the sync save), the first save's pinned-buffer allocation, the mean
   round of rounds 11-20; the async and sync checkpoints of each step
   tensor-equal and their meta equal (timestamps and run ids apart); a
   run resumed from the async step bit-equal to the uninterrupted one;
   a planted fault (the loop not waiting on the snapshot, the copy
   stream asleep before its copies) whose saved tensors must differ; (b)
   SIGTERM sent from a thread after 5 rounds: ``interrupted``, a
   committed checkpoint at a round boundary, the resumed run bit-equal
   to the uninterrupted one; (c) ``nan_grads@3`` for acco, dpu and ddp
   (one skipped round, the target reached, a finite loss);
   ``corrupt_params`` with saves on: the watchdog's rollback, whose
   final state must equal a run resumed from the same checkpoint with
   the loader at the fence, and differ from it with the fence dropped
   (a planted fault); (d) telemetry on and off under torch.profiler:
   equal counts of synchronizing CUDA runtime calls, the mean rounds
   (and again unprofiled), the trace valid and the attribution's
   buckets within 5% of the round wall; (e) ``train.profile_steps=4`` on
   Llama-125M and llama3-8B-L8192: the summary's ``profile`` beside
   phase 7's overlap share;
11. the rounds captured and replayed against eager rounds
   (``build_trainer(..., eager=True)``): (a) every phase-5 cell again
   eager: Llama-125M under acco, dpu and ddp, its fused-CE cell and
   GPT-Neo-125M bit-equal over the seed round and 8 rounds (losses, LRs,
   flags, a fingerprint of every final state leaf), the other cells
   printed (held to the ring's loss bar if they differ), the launch
   counts equal; (b) planted faults in the captured rounds: the block's
   copy into the static block dropped, the metric slot's copy dropped
   (read back once, after the 8 rounds), the buffer sets swapped out of
   phase,
   each of which must differ from the eager run; (c) per cell, captured
   against eager: median round ms, idle share and device ms a
   microbatch (phase 7's profile and, for Llama-125M and the long cell, an
   eager one), kernel launch calls,
   graph launches and kernels a round, peak allocated (captured within
   5% of eager) and reserved, allocator retries (none on the long
   cells), capture ms and ``train_warmup_join_ms``; Llama-125M and its
   fused-CE cell at cadence 10 eager beside phase 8 (d); Llama-125M with
   no library loaded, ``train.warmup_compile`` true from an empty build
   directory and false from the build cache (each program captured after
   its first round): the seconds from the trainer's constructor to its
   first round;
   (d) ``nan_grads@3``, the ``corrupt_params`` rollback (their captured
   runs phase 10 (c)'s, since PR 18) and a SIGTERM stop resumed,
   captured, bit-equal to their eager oracles;
12. serving, in the order (b), (c), (d), (a) (``acco_tpu_torch/serve/``;
   no hand kernel: the serving path's products and attention are plain
   PyTorch, as the JAX package computes them outside any Pallas kernel):
   (a) the full-depth
   Llama-3-8B replica of ``config/serve/llama3-8b.yaml`` (32 layers, bf16
   params and cache, pages of 16, 2048 pages, context 4096, 8 slots),
   its parameters drawn on the card from seed 0: one prompt prefilled in
   each of eight buckets (16 to 4096; each bucket's second call timed),
   32 decode steps over the 8 slots eager and the same 32 captured as a
   CUDA graph from the same pools, bit-equal (logits and both pools),
   the scheduler's step (decode + greedy sample) timed, a profiled
   window of decode steps (launch calls, graph launches, idle share),
   the capture ms and the peak memory beside the pool's bytes; (b)
   Llama-125M and GPT-Neo-125M (window 256: the band lane, and its full
   lane beside it) in float32, TF32 off: a 601-token prefill and 40
   decode steps (page 16, context 1024) against one forward of the whole
   sequence at 1e-4; (c) planted faults that (b)'s bar must catch: the
   captured step's page table rebound instead of copied, ``write_token``
   one position late, the band's first page one late; (d) ``python -m
   acco_tpu_torch.serve`` serving a Llama-125M ``params.npz`` written
   here (bf16, 8 slots, the byte tokenizer; started beside (b) and (c)),
   ``python -m acco_tpu_torch.serve.load_harness --url`` against it for
   10 s at concurrency 8 (no 500, TTFT p50/p99,
   tokens/s, no page in use after), then 8 requests in flight and
   SIGTERM: the drain finishes them within its budget and the server
   exits 0;
13. tensor parallelism: (a) K3's vocab-parallel wrapper
   (``ops/fused_ce.py`` ``vocab_parallel_fused_ce_loss``) at GPT-Neo-
   125M's head (8192 rows, D 768, vocab 50257 padded to 50304, random
   padding rows, smoothing 0.1, ignored rows) and Llama-3-8B's (8192
   rows, D 4096, V 128256), tp 2 and tp 4, and Llama-3-8B's at phase
   15's stage (2048 rows) over 1 shard (as the stage's one-rank (pp, tp)
   group runs it) and 16 (the preset's pp x tp: 8016 columns a shard),
   emulated in one process: each
   shard through the wrapper's own per-shard step (``vp_shard_ce`` at
   its rank: K3 on its slice with its clipped ``v_real`` and its targets
   localised with the -1 sentinel), the slices combined by the wrapper's
   own combine (``vp_combine``), against K3 over the whole unpadded vocab
   and against the plain version emulated alike, at K3's bars (dH's |ref|
   the sum of the shards' bf16 parts' magnitudes, which the ranks'
   all-reduce sums); three planted faults the bars must fail (the
   per-shard step patched to leave the last shard's ``v_real`` unclipped
   and to leave the targets global, the sum of dH over the shards
   dropped); shard 0's K3 forward and backward timed
   beside its plain version, its bound (2 N D V/tp a pass) and the
   materialized vocab-parallel CE on the same slice; (b) the tp paths
   through a one-rank NCCL tensor group handed to ``build_trainer``:
   ``llama3-8B-L8192-tp`` (K5 and the wrapper) bit-equal to phase 5's
   dense cell, ``gptneo-tp`` (K1, K2 and the wrapper, ``fused_loss=
   pallas``) against phase 5's GPT-Neo cell (its materialized CE: the
   seed loss within 1e-5, the rounds within the ring's bar), the seed
   round and 8 captured rounds each, the wrapper's launches counted;
14. pipeline parallelism through a one-rank NCCL pipeline group handed to
   ``build_trainer`` (the GPipe tick loop of ``parallel/pp.py`` with its
   per-tick recompute, the masked broadcast, the vocab-parallel lookup
   and CE over the group, ZeRO-1's terms over it, the capture) at pp 1:
   (a) ``gptneo-2.7B-stage-pp``: GPT-Neo-2.7B at full width (the
   registry's hidden 2560, 20 heads of 128, vocab 50257, W 256) cut to
   the 8 layers one stage of ``config/train/acco-neo27b-v5e8.yaml``
   ({dp: 2, pp: 4}, 32 layers) holds, seq 1024, batch 8, n_acc 4,
   ``remat=true``, ``fused_loss=pallas``, ACCO, the seed round + 8 rounds
   (K1, K2, K3 through the wrapper), beside the same cell dense; (b)
   ``llama3-8B-L8192-pp``: phase 5's long-context cell's model and data
   through the pipeline (K5, the untied head through the wrapper),
   against phase 5's dense cell (captured only since PR 18: phase 15 holds
   the pp code captured against eager); bars: the seed loss within 1e-5
   (relative) of the dense cell, every later round within 1e-3; round ms,
   peak allocated and reserved, each kernel's launches a microbatch;
15. the compositions (``parallel/mesh.RankGroups.around``: one one-rank
   NCCL group per axis, the comm twins, the world and the combined (pp,
   tp) group made around them, handed to ``build_trainer`` together; the
   groups destroyed after each cell): (a) ``llama3-8B-v5e32-stage``:
   Llama-3-8B at full width (untied, D 128, 32 heads, 8 KV heads, vocab
   128256) cut to 2 of the 4 layers one stage of
   ``config/train/acco-llama3-v5e32.yaml`` ({dp: 2, pp: 8, tp: 2}) holds,
   that preset's seq 512, batch 4, n_acc 8, ``remat=dots``,
   ``fused_loss`` auto (K1 at Llama-3-8B's width, K3), dense and then
   through pp and tp (``-pptp``: ``ComposedLayout``, the wrapper over the
   combined group, the tick's recompute): the seed loss bit-equal, the
   rounds within 1e-4 relative; (b) ``llama3-8B-L8192-ring-4axis``: phase
   5's long ring cell through dp, pp, tp and sp, and (c)
   ``gptneo-ring-tpsp`` and ``gptneo-ring-ppsp``: phase 5's GPT-Neo ring
   cell through (tp, sp) and (pp, sp), each bit-equal to its phase-5 cell
   (losses, and the final state with its flat vectors read in the dense
   order); every composed cell captured, then eager: bit-equal; round ms
   both ways, peak allocated and reserved, each kernel's launches a
   microbatch, the NCCL communicators' count and the card memory outside
   the allocator's reserve before the groups, after their first run and
   after they are destroyed;
16. the static gates (``acco_tpu_torch/analysis/``): (a) the rules and
   dtype gates over the final state of every cell above and of phase
   12's serve replica, and the in-place watch (each state leaf in the
   buffer sets) over every captured round and the replica's captured
   decode steps; (b) the census and the overlap verdict on phase 7's
   profiled Llama-125M trace; (c) the program registry on the card
   (tiny ACCO, DPU, DDP, eval, serve prefill and decode, captured; the
   train steps on the one-rank NCCL group): rules, dtypes, the census
   read from a profiled round's ``record_param_comms`` against the call
   sites, the in-place check across replays with ``memory_allocated()``
   flat, the overlap verdict on four profiled captured Llama-125M ACCO
   rounds; (d) the
   memory sieve's state bytes against the rise of
   ``memory_allocated()`` across ``init_state`` for Llama-125M and the
   long cell.

The last lines are the kernels JSON line, nvidia-smi's line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(B=8, H=12, Hkv=12, L=1024, D=64, window=0, pad=False)
SMALL = dict(B=2, H=4, Hkv=2, L=512, D=64, window=256, pad=True)
# K1 at Llama-3-8B's width (head_dim 128, GQA 32 / 8) at the shape phase
# 15's stage of config/train/acco-llama3-v5e32.yaml gives it (batch 4 x
# seq 512), where 'auto' resolves to K1 on the card as JAX's resolver
# does on the TPU
K1_LLAMA3 = dict(B=4, H=32, Hkv=8, L=512, D=128, window=0, pad=False)
# K1 where rows have no allowed key: left padding (rows 0 .. L/8 - 1 of
# batch 0), and with a window 16 wide a run of 32 pads (17 more such rows);
# L 320 is a multiple of 64 but not of 128 (a half tile of rows and keys)
K1_NO_KEY = dict(B=2, H=4, Hkv=2, L=320, D=128, window=16, pad="left+run")
K1_SHAPES = (
    ("flagship", FLAGSHIP),
    ("small gqa+window+pad", SMALL),
    ("gpt-neo global, scale 1.0", None),  # NEO_GLOBAL, below
    ("llama-3-8B width, D 128, the v5e32 stage's B 4 x L 512", K1_LLAMA3),
    ("left padding: rows with no allowed key, D 64", dict(B=2, H=4, Hkv=2, L=512, D=64, window=0,
                                                        pad="left")),
    ("rows with no allowed key, window 16, L 320, D 128", K1_NO_KEY),
    ("L 320, gqa, D 64, window 100, left padding", dict(B=2, H=4, Hkv=2, L=320, D=64, window=100,
                                                      pad="left")),
    ("rows with no allowed key, float32, D 128", dict(B=2, H=4, Hkv=2, L=192, D=128, window=0,
                                                     pad="left", dtype="float32")),
)
# GPT-Neo scores are unscaled (scale 1.0): q and k are drawn with std
# D^-1/4 so that the scores still have unit variance
NEO_QK_STD = 64 ** -0.25
NEO_GLOBAL = dict(B=8, H=12, Hkv=12, L=1024, D=64, window=0, pad=False,
                  scale=1.0, qk_std=NEO_QK_STD)
K1_SHAPES = tuple((label, shape or NEO_GLOBAL) for label, shape in K1_SHAPES)
# K2 (MHA, no pad): GPT-Neo-125M's local layer, an odd window, the widest
# band of the envelope (nprev(897) + 1 = 8 blocks of 128 keys), and
# GPT-Neo-2.7B's local layer (config/model/gptneoLarge.yaml: hidden 2560,
# 20 heads of 128, window 256, 2048 positions; its stated hyperparameters,
# at batch 1)
NEO_LOCAL = dict(B=8, H=12, L=1024, D=64, window=256)
NEO_LARGE_LOCAL = dict(B=1, H=20, L=2048, D=128, window=256)
BANDED_SHAPES = (
    ("gpt-neo local", NEO_LOCAL),
    ("odd window", dict(B=2, H=4, L=512, D=64, window=129)),
    ("widest band", dict(B=2, H=4, L=1024, D=64, window=897)),
    ("gpt-neo-2.7B local, D 128", NEO_LARGE_LOCAL),
    ("odd window, D 128", dict(B=2, H=4, L=384, D=128, window=129)),
)
# main paths at full width: Llama-125M (config/model/llama-125M.json),
# GPT-Neo-125M (config/model/gpt-neo-125M.json, 6 global + 6 local layers)
# and Llama-125M with the fused lm-head + CE (train.fused_loss=pallas)
MAIN_ROUNDS = 8  # after the seed round
LAYERS, D_MODEL, SEQ, BATCH = 12, 768, 1024, 8
NEO_WINDOW = 256
VOCAB = 50257

# K3 shapes: rows N of hidden states, hidden D, vocab V, real vocab, label
# smoothing, the share of ignored rows, and (seq) every seq-th row ignored,
# as the main path ignores the last row of each sequence. With
# softmax_only the cotangents are a random signed d_lse per row and no
# d_tl or d_sl: dlogits is then the softmax term alone, which under the
# mean loss's cotangents is too small a part of dH to show a fault in it;
# and, d_lse differing from row to row, a block that reads another row
# tile's stats gets another result.
CE_LLAMA = dict(N=BATCH * (SEQ - 1), D=D_MODEL, V=VOCAB, v_real=VOCAB, smoothing=0.0, ignore=0.0)
# Llama-3-8B's head at phase 15's stage: batch 4 x seq 512 rows, the last
# of each sequence ignored (the pipeline's pre-shifted labels)
CE_LLAMA3 = dict(N=2048, D=4096, V=128256, v_real=128256, smoothing=0.0, ignore=0.0, seq=512)
CE_SHAPES = (
    ("llama-125M head", CE_LLAMA),
    ("llama-125M head, softmax term alone", {**CE_LLAMA, "softmax_only": True}),
    ("small unaligned", dict(N=2 * 32, D=128, V=277, v_real=256, smoothing=0.1, ignore=0.25)),
    ("llama-3-8B head, the v5e32 stage's 2048 rows", CE_LLAMA3),
    ("llama-3-8B head, the v5e32 stage's 2048 rows, softmax term alone",
     {**CE_LLAMA3, "softmax_only": True}),
)
CE_MAIN = dict(N=BATCH * SEQ, D=D_MODEL, V=VOCAB, v_real=VOCAB, smoothing=0.0, ignore=0.0,
               seq=SEQ)
# the long-context cells' head: Llama-3-8B's (D 4096, V 128256) at batch 1 x
# L 8192; its float32 logits are 4.2 GB, so it is timed before the paths
CE_LONG = dict(N=8192, D=4096, V=128256, v_real=128256, smoothing=0.0, ignore=0.0, seq=8192)

# K5 shapes: the Llama-125M flagship (D 64, beside K1), a small GQA shape
# with pads in the middle and at the tail (D 128), and the long-context
# main path's layer (Llama-3-8B: H 32, Hkv 8, D 128, L 8192, batch 1)
FLASH_FLAGSHIP = dict(B=8, H=12, Hkv=12, L=1024, D=64)
FLASH_SMALL = dict(B=2, H=4, Hkv=2, L=512, D=128, pad="middle+tail")
FLASH_LLAMA3 = dict(B=1, H=32, Hkv=8, L=8192, D=128)
FLASH_SHAPES = (
    ("llama-125M flagship", FLASH_FLAGSHIP),
    ("small gqa, pads in the middle and at the tail", FLASH_SMALL),
    ("small gqa, pads, float32", {**FLASH_SMALL, "dtype": "float32"}),
    ("llama-3-8B, L 8192", FLASH_LLAMA3),
    ("L 320 (a half tile), gqa, pads, D 128", {**FLASH_SMALL, "L": 320}),
    ("L 320 (a half tile), gqa, D 64", dict(B=2, H=4, Hkv=2, L=320, D=64)),
)
# K4 (the ring's block) shapes: (a) the Llama-350M preset's per-device
# block, a zig-zag half-chunk of Lc 2048 at sp 16; (b) Llama-3-8B at the
# card's ring path's half-chunk (L 8192 at sp 1); (c) GPT-Neo-125M's
# positional block at the positions of a zig-zag hop at sp 2, L 2048
# (rank 1's queries against rank 0's keys: with window 256 the queries at
# 768..1535 have no key left, and their rows are fully masked); (d) small,
# float32, with ties planted at each row's max. Each shape lists its
# variants: 'full', 'diag', or (query positions, key positions, window).
# (e) has Lq != Lk, both half tiles of 128: its queries sit at the last Lq
# of the Lk key positions ('rect w<window>').
BLOCK_350M = dict(B=1, H=16, Hkv=16, L=1024, D=64)
BLOCK_LLAMA3 = dict(B=1, H=32, Hkv=8, L=4096, D=128)
BLOCK_NEO = dict(B=8, H=12, Hkv=12, L=1024, D=64, scale=1.0, qk_std=NEO_QK_STD)
BLOCK_TIES = dict(B=2, H=4, Hkv=2, L=128, D=64, dtype="float32", ties=True)
BLOCK_TIES_BF16 = {**BLOCK_TIES, "dtype": "bfloat16"}
BLOCK_SMALL = dict(B=2, H=4, Hkv=2, L=128, D=64)
BLOCK_RECT = dict(B=2, H=4, Hkv=2, L=192, Lk=320, D=64)
# (query rank, key rank, global length, ranks, window) of a zig-zag hop
ZZ_NEO = {f"hop sp2 w{w}": (1, 0, 2048, 2, w) for w in (0, NEO_WINDOW)}
ZZ_SMALL = {"hop w0": (1, 0, 256, 2, 0), "hop w48": (1, 0, 256, 2, 48),
            "self w48": (0, 0, 256, 2, 48)}
# a hop whose key blocks' spans of positions exclude q steps that hold
# rows with no allowed key (L 512 a rank): dK/dV must walk those steps
# for the rows' dV (P = 1), which their spans alone would skip
BLOCK_MID = dict(B=1, H=4, Hkv=2, L=512, D=64)
ZZ_MID = {"hop 2x512 w48": (1, 0, 1024, 2, 48), "hop 2x512 w0": (1, 0, 1024, 2, 0)}
RECT = ("full", "rect w0", "rect w100")
BLOCK_SHAPES = (
    ("(a) llama-350M preset's block at sp 16", BLOCK_350M, ("full", "diag")),
    ("(b) llama-3-8B, the card ring path's half-chunk", BLOCK_LLAMA3, ("full", "diag")),
    ("(c) gpt-neo-125M, a zig-zag hop at sp 2, L 2048", BLOCK_NEO, tuple(ZZ_NEO)),
    ("(d) small, planted ties, float32", BLOCK_TIES, ("full", "diag", *ZZ_SMALL)),
    ("(d) small, planted ties, float32, D 128", {**BLOCK_TIES, "D": 128},
     ("full", "diag", *ZZ_SMALL)),
    ("(d) small, planted ties, bf16, dm != 0", BLOCK_TIES_BF16, ("full", "diag", *ZZ_SMALL)),
    ("(d) small, planted ties, bf16, dm != 0, D 128", {**BLOCK_TIES_BF16, "D": 128},
     ("full", "diag", *ZZ_SMALL)),
    ("small gqa, bf16", BLOCK_SMALL, ("full", "diag", *ZZ_SMALL)),
    ("small gqa, bf16, L 512, hops whose spans skip q steps", BLOCK_MID, tuple(ZZ_MID)),
    ("(e) Lq 192 != Lk 320, half tiles, bf16", BLOCK_RECT, RECT),
    ("(e) Lq 192 != Lk 320, half tiles, bf16, D 128", {**BLOCK_RECT, "D": 128}, RECT),
    ("(e) Lq 192 != Lk 320, float32", {**BLOCK_RECT, "dtype": "float32"}, RECT),
)
# the long-context main path: config/model/llama-3-8B.json at full width
# (d 4096, 32 heads, 8 KV heads, vocab 128256, untied head) cut to 2
# layers, written at run time into a temporary directory
LLAMA3_JSON = os.path.join(REPO, "config", "model", "llama-3-8B.json")
LLAMA3_LAYERS, LLAMA3_SEQ = 2, 8192


@functools.cache
def llama3_config() -> str:
    """The depth-cut Llama-3-8B architecture file, written once per run
    into a temporary directory that is removed at exit."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    with open(LLAMA3_JSON) as f:
        raw = json.load(f)
    raw["num_layers"] = LLAMA3_LAYERS
    path = os.path.join(tmp, f"llama-3-8B-depth{LLAMA3_LAYERS}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


# phase 14's pipeline stage: GPT-Neo-2.7B at full width (the registry's
# preset for config/model/gptneoLarge.yaml) cut to the 8 layers that one
# stage of config/train/acco-neo27b-v5e8.yaml ({dp: 2, pp: 4}, 32 layers)
# holds, written at run time into a temporary directory
NEO27_PRESET, NEO27_LAYERS = "EleutherAI/gpt-neo-2.7B", 8


@functools.cache
def neo27_stage_config() -> str:
    """The depth-cut GPT-Neo-2.7B architecture file (the registry's widths,
    the first ``NEO27_LAYERS`` layers' global/local pattern), written once
    per run into a temporary directory that is removed at exit."""
    import dataclasses

    from acco_tpu_torch.models.registry import model_config

    _, cfg = model_config(NEO27_PRESET)
    raw = dataclasses.asdict(cfg)
    raw.update(model_type="gpt_neo", num_layers=NEO27_LAYERS,
               attention_layers=list(cfg.attention_layers[:NEO27_LAYERS]))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    path = os.path.join(tmp, f"gpt-neo-2.7B-depth{NEO27_LAYERS}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@functools.cache
def run_root() -> str:
    """A temporary directory, removed at exit, for the run dirs of the
    trainers the script builds."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    atexit.register(shutil.rmtree, tmp, True)
    return tmp


def run_flags(cadence: int = 1) -> list[str]:
    """Phases 5-7's runs write no checkpoint (a long path's would be ~27
    GB), keep their records in the temporary run dir and read their
    rounds back every ``cadence`` grads (1: each round's ms is synced)."""
    return ["train.save=false", f"hydra.run.dir={run_root()}/runs",
            f"+train.delta_step_for_log={cadence}"]


def main_args(path: str, cadence: int = 1) -> list[str]:
    spec = (MAIN_PATHS.get(path) or DP_PATHS.get(path) or REMAT_PATHS.get(path)
            or PP_PATHS.get(path) or COMPOSED_PATHS[path])
    extra = [f"model.config_path={llama3_config()}"] if spec.get("llama3") else []
    if spec.get("neo27"):
        extra = [f"model.config_path={neo27_stage_config()}"]
    n_acc = spec.get("n_acc", 1)
    return [
        f"train={spec.get('method', 'acco')}", f"model={spec['model']}", *extra,
        "data=synthetic",
        f"train.batch_size={spec['batch']}", f"train.max_length={spec['seq']}",
        f"train.n_grad_accumulation={n_acc}", f"train.nb_steps_tot={MAIN_ROUNDS * n_acc}",
        *spec["extra"], *run_flags(cadence),
    ]

# Tolerances on the card, bf16 (kernel vs its plain version, same inputs):
# outputs are rounded to bf16 (relative step 2^-8) and summed in another
# order; the plain forward also rounds P to bf16 before PV where the
# online-softmax kernel keeps it in f32. Each check is
# |kernel - plain| <= atol + rtol * |plain|.
TOL = {
    "o": (1e-2, 2e-2),
    # K2 rounds the normalised P, as its plain version does: O differs only
    # where another summation order flips a bf16 rounding of P or of O
    # (one bf16 step of O, 2^-7 relative)
    "o_band": (4e-3, 8e-3),
    # float32 sums of exact bf16 products in another order; a logit rounded
    # to bf16 would be off by up to 2^-9 of itself (1e-3 at |logit| 0.5)
    "logits": (1e-5, 1e-5),
    "lse": (1e-3, 1e-4),  # float32 in both; only the summation order differs
    "delta": (1e-3, 1e-4),  # float32 dot products of identical bf16 inputs
    "dq": (1e-2, 2e-2),
    "dk": (1e-2, 2e-2),
    "dv": (1e-2, 2e-2),
    # K3's per-row float32 lse and true logit: exact bf16 products summed
    # in another order (the sum of the real logits: check_mass)
    # K4's row statistics: float32 on both sides; m and l differ only by
    # the summation order of s, c = (dm - rowsum(dO o) - dl l) / cnt only
    # by that of its dot product
    "blk_m": (1e-3, 1e-4),
    "blk_l": (1e-3, 1e-4),
    "blk_c": (1e-3, 1e-4),
    "ce_lse": (1e-4, 1e-5),
    "ce_tl": (1e-4, 1e-5),
}
# K5 in float32 against its plain version in float32: no rounding to bf16
# on either side, only the summation order differs (the end-to-end
# float32 agreement's 1e-4 bar)
F32_TOL = (1e-4, 1e-4)
# K3's dH and dW, elementwise: |err| <= r * |plain| + t * term, where term
# bounds each product summed into the element (``ce_grad_terms``).
# Both sides round dlogits to bf16 before their products and the result
# to bf16 at the end. The final rounding can differ by one bf16 step of
# the element (2^-7 of it): r = 2^-6. A float32 dlogit on a rounding edge
# can round the other way on the other side and move its product by one
# bf16 step of itself (at most 2^-7 of it), which shows in full where the
# sum cancels: t = 2^-6 allows two such steps. The bar stays far
# below the typical element, so that a dlogit term dropped or misweighted
# fails (phase 3's planted faults).
ELEMENT_TOL = {"ce_dh": (2 ** -6, 2 ** -6), "ce_dw": (2 ** -6, 2 ** -6)}
# K3's dp buffer against the plain version's bf16 dlogits: equal, except
# where the two float32 values lie on either side of a bf16 rounding edge.
# The kernel's float32 dlogit differs from the plain one only by the
# summation order of its logit and by expf's last bits (about 2^-20 of
# itself); an element may round the other way, by one bf16 step, only
# where the plain float32 value lies within DP_EDGE_RTOL of itself from
# the midpoint of the two bf16 values. The pad columns [V, Vp) are 0.
DP_EDGE_RTOL = 2 ** -12
# K3's sum of the real logits adds V float32 terms, each itself a sum of D
# products taken in another order: |err| <= 2^-22 * sum over the row of
# |logit| (4 float32 steps of the row's absolute mass)
MASS_RTOL = 2 ** -22


def free_device_cache() -> None:
    """Collect unreachable objects, then return the allocator's cached
    blocks: a finished trainer caught in a reference cycle (the first one
    of a process is: torch keeps the frames of a lazy import made during
    its first round, the trainer's among them) would otherwise hold its
    device state until Python's cyclic collector happens to run."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") carries the seconds
    since the script started."""
    if msg.startswith("== "):
        msg = f"{msg}  [t+{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(name: str, got, want, tol=None) -> float:
    import torch

    atol, rtol = tol or TOL[name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {atol:g} + {rtol:g}*|ref|)")
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside tolerance "
            f"(max abs err {max_err:.3e})"
        )
    return max_err


def check_mass(name: str, got, want, mass) -> float:
    """|got - want| <= MASS_RTOL * mass, elementwise."""
    import torch

    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {MASS_RTOL:g}*sum|logit|, "
        f"max {float((err / mass).max()):.3e} of the mass)")
    if not bool(torch.isfinite(got).all()) or bool((err > MASS_RTOL * mass).any()):
        raise AssertionError(f"{name}: elements outside tolerance (max abs err {max_err:.3e})")
    return max_err


def check_elementwise(name: str, got, want, term, mass=None) -> float:
    """|got - want| <= r * |want| + t * term, elementwise (``mass`` in
    place of |want| where the element is a sum of parts each rounded on
    its own: the sum of the parts' magnitudes)."""
    import torch

    r, t = ELEMENT_TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = r * (want.abs() if mass is None else mass) + t * term
    used = float((err / tol.clamp(min=torch.finfo(torch.float32).tiny)).max())
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {r:g}*|ref| + {t:g}*term; median |ref| "
        f"{float(want.abs().median()):.3e}, median term {float(term.median()):.3e}; "
        f"worst err/tol {used:.3f})")
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: elements outside tolerance (max abs err {max_err:.3e}, "
                             f"worst err/tol {used:.3f})")
    return max_err


def check_dp(name: str, got, want, exact, vocab: int) -> float:
    """bf16 dp [N, Vp] against the plain bf16 dp: equal but one bf16 step
    at a rounding edge of the plain float32 value ``exact`` [N, V]
    (DP_EDGE_RTOL); 0 in the pad columns."""
    import torch

    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, want bf16 "
                             f"{tuple(want.shape)}")
    if bool((got[:, vocab:] != 0).any()):
        raise AssertionError(f"{name}: nonzero pad columns")
    got, want = got[:, :vocab], want[:, :vocab]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    differ = got != want
    n_diff = int(differ.sum())
    max_err = float((got.float() - want.float()).abs().max())
    if n_diff:
        g, w_, x = got[differ], want[differ], exact[differ]
        steps = (g.view(torch.int16).int() - w_.view(torch.int16).int()).abs()
        same_sign = torch.signbit(g) == torch.signbit(w_)
        mid = (g.float() + w_.float()) / 2
        edge = (x - mid).abs() <= DP_EDGE_RTOL * x.abs()
        bad = ~(same_sign & (steps == 1) & edge)
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {n_diff} differing elements are not one bf16 step "
                f"apart at a rounding edge (max abs err {max_err:.3e})")
    log(f"  {name:5s} max_abs_err {max_err:.3e}  ({n_diff} of {got.numel()} elements one bf16 "
        f"step off, each at a rounding edge within {DP_EDGE_RTOL:g} of itself; pad columns 0)")
    return max_err


def ce_grad_terms(h, w, args) -> tuple:
    """For each element of dH [N, D] and of dW [V, D], a bound on the
    largest |product| in its sum, from the plain version's bf16 dlogits:
    the product of the largest |dlogit| over the contraction, exactly, and
    the second largest |dlogit| times the largest |operand| in the
    element's column for every other product."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    def bound(dp, other):  # dp [rows, K] (|dlogits|), other [K, D]
        top = dp.topk(2, dim=1)
        other = other.float().abs()
        return torch.maximum(top.values[:, :1] * other[top.indices[:, 0]],
                             top.values[:, 1:] * other.amax(0))

    dp = fc.dlogits_reference(*args).float().abs_()
    return bound(dp, w), bound(dp.t(), h)


# Faults planted in the kernels (the source file, the text to replace,
# its replacement, and the kernel whose check must fail it): K3's four bf16
# passes against their bars at the softmax-alone Llama-125M head
# (CE_SHAPES[1]); K5 against its bars at the small GQA shape with pads
# (FLASH_SMALL), where segment ids, the causal diagonal and the online
# rescale all matter; K1 at K1_NO_KEY (a narrow window, rows with no
# allowed key, a half tile), through the mask policy, dK/dV, dQ and the
# conversion of an accumulator into the A fragments of an RS wgmma (in
# hopper_attention.cuh, which K5, K2 and K4 share); K2 at its odd windows
# (D 64 and 128); K4 (its mask policies, its statistics and its backward
# on the mainloop) at the bf16 shapes with planted ties (every mode; dm !=
# 0; rows with no allowed key), the small GQA shape and Lq != Lk
PLANTED_FAULTS = {
    "K3: the forward skips the running sum's rescale": (
        "fused_ce.cu", "l[hh] *= expf(m[hh] - m_new);", "l[hh] *= 1.f;", "K3"),
    "K3: lse + 0.1 in the dp epilogue": (
        "fused_ce.cu", "- lse_r[hh])", "- lse_r[hh] - 0.1f)", "K3"),
    "K3: the softmax term dropped from dp": (
        "fused_ce.cu", "return dl_r[hh] * expf(", "return 0.f * dl_r[hh] * expf(", "K3"),
    "K3: dH's K loop skips its last Vp tile": (
        "fused_ce.cu", "const int k_steps_dh = Vp / hopper::kBK;",
        "const int k_steps_dh = Vp / hopper::kBK - 1;", "K3"),
    "K3: dW's B operand (h) read one 64-row chunk late": (
        "fused_ce.cu", "hopper::make_map(&mb, h, N, D, true)",
        "hopper::make_map(&mb, static_cast<const bf16*>(h) + 64 * (size_t)D, N - 64, D, true)",
        "K3"),
    "K3: dW's middle chunk overwrites the float32 sum": (
        "fused_ce.cu", "if (mode >= 2) {", "if (mode >= 3) {", "K3 chunks"),
    "K5: the mask policy ignores the segment ids": (
        "flash_attention.cu", "return j <= i && qv == kv;", "return j <= i;", "K5"),
    "K5: the mask policy drops the causal diagonal": (
        "flash_attention.cu", "return j <= i && qv == kv;", "return j < i && qv == kv;", "K5"),
    "K4: the tie term (eq c) dropped": (
        "hopper_attention.cuh", "(s == lse ? c : 0.f)", "(s == lse ? 0.f * c : 0.f)", "K4"),
    "K4: dl ignored": (
        "hopper_attention.cuh", "p * (dp + delta)", "p * (dp + 0.f * delta)", "K4"),
    "K4: the window edge off by one": (
        "block_attention.cu", "kp > qp - window", "kp >= qp - window", "K4"),
    "K4: m taken in log2 units": (
        "hopper_attention.cuh", "m[hh] * a.scale;", "m[hh] * scale2;", "K4"),
    "K4: o normalised": (
        "hopper_attention.cuh", "make_float2(o[4 * jj + 2 * hh],",
        "make_float2(o[4 * jj + 2 * hh] / l[hh],", "K4"),
    "K4: the mean of V in place of the sum on a row with no allowed key": (
        "hopper_attention.cuh", "o[x] = cs[8 * (x / 4) + 2 * tq + (x & 1)];",
        "o[x] = cs[8 * (x / 4) + 2 * tq + (x & 1)] / a.Lk;", "K4"),
    "K4: the forward's K map takes Lq keys (Lq and Lk swapped)": (
        "hopper_attention.cuh", "!make_map_3d(&mk, k, D, d.Lk, d.B * d.Hkv, kFwdKeys)",
        "!make_map_3d(&mk, k, D, d.Lq, d.B * d.Hkv, kFwdKeys)", "K4"),
    "K4: dK/dV skips the q steps of the rows with no allowed key": (
        "hopper_attention.cuh",
        "flagged |= fminf(fminf(v.x, v.y), fminf(v.z, v.w)) <= kFlagLse;", "flagged |= false;",
        "K4"),
    "K4: dK/dV's P on those steps from the other rows": (
        "hopper_attention.cuh", "(x & 1)] <= kFlagLse ? 1.f : 0.f;",
        "(x & 1)] <= kFlagLse ? 0.f : 1.f;", "K4"),
    "K4: the positional mask skipped on a tile it does not cover": (
        "block_attention.cu", "return ks.y <= qs.x && (window == 0 || ks.x > qs.y - window);",
        "return ks.x <= qs.x && (window == 0 || ks.x > qs.y - window);", "K4"),
    "K4: the positional walk skips tiles it must walk": (
        "block_attention.cu", "return ks.x <= qs.y && (window == 0 || ks.y > qs.x - window);",
        "return ks.x < qs.x && (window == 0 || ks.y > qs.x - window);", "K4"),
    "K2: the band one tile short": (
        "banded_attention.cu", "return max(0, q0 - window + 1); }",
        "return max(0, q0 - window + 1 + 128); }", "K2"),
    "K5: the forward skips the output's rescale": (
        "hopper_attention.cuh", "o[x] *= corr[(x / 2) % 2];", "o[x] *= 1.f;", "K5"),
    "K1: the mask policy's window one key wider": (
        "fused_attention.cu", "(window == 0 || i - j < window)", "(window == 0 || i - j <= window)",
        "K1"),
    "K1: dK/dV drops delta from dS": (
        "hopper_attention.cuh", "float ds = p * (dpt[x] - dl[col]);", "float ds = p * dpt[x];",
        "K1"),
    "K1: dQ's P off by exp(-0.1)": (
        "hopper_attention.cuh", "exp2_approx((sc[x] - lse_r[hh]) * kLog2e)",
        "exp2_approx((sc[x] - lse_r[hh] - 0.1f) * kLog2e)", "K1"),
    "K1: the RS A fragments' row halves swapped": (
        "hopper_attention.cuh",
        "a[kk][1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);\n"
        "    a[kk][2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);",
        "a[kk][1] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);\n"
        "    a[kk][2] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);", "K1"),
}
FAULT_CHECKS = {
    "K3": lambda: ce_parity(CE_SHAPES[1][1], 7),
    "K3 chunks": lambda: ce_chunked_parity(CE_LLAMA, 11),
    "K5": lambda: flash_parity(FLASH_SMALL, 21),
    "K1": lambda: parity(K1_NO_KEY, 5),
    "K2": lambda: (banded_parity(BANDED_SHAPES[1][1], 4), banded_parity(BANDED_SHAPES[4][1], 7)),
    "K4": lambda: (block_parity(BLOCK_TIES_BF16, 31, ("full", "diag", *ZZ_SMALL)),
                   block_parity(BLOCK_SMALL, 32, ("full", *ZZ_SMALL)),
                   block_parity(BLOCK_MID, 34, tuple(ZZ_MID)),
                   block_parity(BLOCK_RECT, 33, RECT)),
}
# run in the copy: exits 0 if the check failed the fault, 3 if it passed it
_FAULT_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
try:
    cs.FAULT_CHECKS[sys.argv[2]]()
except AssertionError as exc:
    print("caught:", exc)
    sys.exit(0)
sys.exit(3)
"""


# planted faults built and checked at once, one a CPU core of an 8-core
# host, from the end of phase 2 on, beside phase 3's parity checks on the
# card: each of K3's checks holds a few float32 [8184, 50257] tensors (1.6
# GB each) of its plain version, so eight fit the card beside the parity
FAULT_PROCS = 8
# the libraries each planted fault's check loads (K2's backward also runs
# K1's delta kernel)
FAULT_LIBRARIES = {"K3": ("fused_ce",), "K3 chunks": ("fused_ce",), "K5": ("flash_attention",),
                   "K1": ("fused_attention",), "K2": ("banded_attention", "fused_attention"),
                   "K4": ("block_attention",)}


class PlantedFaults:
    """Each fault of PLANTED_FAULTS in its own patched copy of the package
    and its own process, FAULT_PROCS at a time on a thread started here:
    the libraries its check loads built with nvcc in the copy (one the
    patch leaves as it was is copied from this checkout's build), then
    the check, which must fail the fault. :meth:`wait` joins them and
    raises for a fault that built badly, passed or did not run."""

    def __init__(self):
        import threading

        from acco_tpu_torch.compile.cache import library_key
        from acco_tpu_torch.utils import cuda_build

        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
        atexit.register(shutil.rmtree, self.tmp, True)
        self.results, jobs = {}, []
        self.t0, self.seconds = time.perf_counter(), float("nan")
        for i, (fault, (source, old, new, kernel)) in enumerate(PLANTED_FAULTS.items()):
            root = os.path.join(self.tmp, str(i))
            shutil.copytree(os.path.join(REPO, "acco_tpu_torch"),
                            os.path.join(root, "acco_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
            csrc = os.path.join(root, "acco_tpu_torch", "csrc")
            with open(os.path.join(csrc, source)) as f:
                src = f.read()
            if src.count(old) != 1:
                raise AssertionError(f"planted fault {fault!r}: its patch no longer applies")
            with open(os.path.join(csrc, source), "w") as f:
                f.write(src.replace(old, new))
            os.makedirs(os.path.join(root, "build"))
            nvcc, build_s = [], 0.0
            for name in FAULT_LIBRARIES[kernel]:
                out = os.path.join(root, "build", f"{name}-{library_key(name, csrc)}.so")
                built = cuda_build.BUILD_DIR / f"{name}-{library_key(name)}.so"
                if os.path.basename(out) == built.name:
                    shutil.copy(built, out)
                else:
                    nvcc.append([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
                                 os.path.join(csrc, f"{name}.cu")])
                    build_s += cuda_build.BUILD_INFO.get(name, {}).get("seconds", 0.0)
            jobs.append((build_s, (fault, root, kernel, nvcc)))
        # the longest builds first (phase 2's nvcc seconds): the pool's tail
        # is then the short ones
        jobs = [job for _, job in sorted(jobs, key=lambda j: -j[0])]
        self.thread = threading.Thread(target=self._run, args=(jobs,), daemon=True)
        self.thread.start()

    def _one(self, job) -> None:
        fault, root, kernel, nvcc = job
        for cmd in nvcc:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                self.results[fault] = ("build", proc.returncode, proc.stderr[-2000:])
                return
        log_path = os.path.join(root, "check.log")
        with open(log_path, "w") as out:  # no pipe to fill
            proc = subprocess.run([sys.executable, "-c", _FAULT_CHILD, root, kernel],
                                  stdout=out, stderr=subprocess.STDOUT, text=True, timeout=600)
        with open(log_path) as f:
            self.results[fault] = ("check", proc.returncode, f.read())

    def _run(self, jobs) -> None:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(FAULT_PROCS) as pool:
            list(pool.map(self._one, jobs))
        self.seconds = time.perf_counter() - self.t0

    def wait(self) -> None:
        t0 = time.perf_counter()
        self.thread.join()
        log(f"  the {len(PLANTED_FAULTS)} planted faults built and checked in {self.seconds:.1f} s, "
            f"beside the parity checks and phase 6 (waited {time.perf_counter() - t0:.1f} s "
            "for them)")
        for fault in PLANTED_FAULTS:
            if fault not in self.results:
                raise AssertionError(f"planted fault {fault!r}: its build or check did not run")
            stage, rc, out = self.results[fault]
            caught = [line for line in out.splitlines() if line.startswith("caught:")]
            if stage == "build":
                raise AssertionError(f"planted fault {fault!r}: nvcc exited {rc}:\n{out}")
            if rc == 3:
                raise AssertionError(f"planted fault {fault!r} passed its check:\n{out[-2000:]}")
            if rc != 0 or not caught:
                raise AssertionError(f"planted fault {fault!r}: the check exited {rc}:\n"
                                     f"{out[-2000:]}")
            log(f"  {fault}: {caught[0]}")


def planted_faults(faults: "PlantedFaults | None" = None) -> None:
    """The planted faults' checks (``faults``, started here when not given)
    joined and reported; raises unless each check failed its fault."""
    (faults or PlantedFaults()).wait()


def make_inputs(shape: dict, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, L, D = (shape[k] for k in ("B", "H", "L", "D"))
    Hkv = shape.get("Hkv", H)
    qk_std = shape.get("qk_std", 1.0)

    dtype = getattr(torch, shape.get("dtype", "bfloat16"))

    def randn(*s, std=1.0):
        return (torch.randn(*s, generator=g, device="cuda") * std).to(dtype)

    q, k = randn(B, H, L, D, std=qk_std), randn(B, Hkv, L, D, std=qk_std)
    v, dout = randn(B, Hkv, L, D), randn(B, H, L, D)
    pad = None
    if shape.get("pad"):
        # right padding, as the loader pads: no query row is left without
        # an allowed key, so every row is compared
        pad = torch.ones(B, L, dtype=torch.int32, device="cuda")
        pad[-1, L - L // 5:] = 0
        if shape["pad"] == "middle+tail":  # K5's segment ids: pad rows are compared too
            pad[0, L - L // 5:] = 0
            pad[-1, L // 3:L // 3 + 40] = 0
        elif shape["pad"] in ("left", "left+run"):
            # K1: left padding, so rows 0 .. L/8 - 1 of batch 0 see no key
            # (normalised over all L keys, as JAX's whole-row softmax does)
            pad[0, :L // 8] = 0
            if shape["pad"] == "left+run":  # and a run of pads twice the window
                pad[-1, L // 3:L // 3 + 2 * shape["window"]] = 0
    return q, k, v, dout, pad


def check_rerun(name: str, first, again) -> None:
    """A backward kernel run twice on the same inputs gives the same bits
    (no atomics: every element is summed by one thread in a fixed order)."""
    import torch

    torch.cuda.synchronize()
    for a, b in zip(first, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: a second run differs in {int((a != b).sum())} elements")
    log(f"  {name}: a second run gives the same bits")


def parity(shape: dict, seed: int) -> dict:
    """Every kernel against its plain version, and each backward kernel
    against a second run of itself; returns max errors."""
    import torch

    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, pad = make_inputs(shape, seed)
    window, scale = shape["window"], shape.get("scale", shape["D"] ** -0.5)
    f32 = q.dtype == torch.float32

    def tol(name):
        return F32_TOL if f32 else TOL[name]

    errs = {}
    o, lse = fa.attn_fwd(q, k, v, pad, window, scale)
    o_ref, lse_ref = fa.attention_reference(q, k, v, pad, window, scale)
    torch.cuda.synchronize()
    errs["attn_fwd"] = max(check("o", o, o_ref, tol("o")), check("lse", lse, lse_ref, tol("lse")))
    # The backward kernels get the same inputs as their plain versions: the
    # kernel forward's O and LSE, the kernel delta.
    delta = fa.attn_bwd_delta(o, dout)
    torch.cuda.synchronize()
    errs["attn_bwd_delta"] = check("delta", delta, fa.delta_reference(o, dout), tol("delta"))
    args = (q, k, v, pad, dout, lse, delta, window, scale)
    dk, dv = fa.attn_bwd_dkdv(*args)
    dk_ref, dv_ref = fa.attn_bwd_dkdv_reference(*args)
    torch.cuda.synchronize()
    errs["attn_bwd_dkdv"] = max(check("dk", dk, dk_ref, tol("dk")),
                                check("dv", dv, dv_ref, tol("dv")))
    dq = fa.attn_bwd_dq(*args)
    dq_ref = fa.attn_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    errs["attn_bwd_dq"] = check("dq", dq, dq_ref, tol("dq"))
    check_rerun("attn_bwd_dkdv", (dk, dv), fa.attn_bwd_dkdv(*args))
    check_rerun("attn_bwd_dq", (dq,), (fa.attn_bwd_dq(*args),))
    return errs


def banded_parity(shape: dict, seed: int) -> dict:
    """Every K2 kernel against its plain version at scale 1.0 (GPT-Neo's
    unscaled scores), and each backward kernel against a second run of
    itself; returns max errors."""
    import torch

    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, _ = make_inputs({**shape, "qk_std": shape["D"] ** -0.25}, seed)
    window, scale = shape["window"], 1.0
    errs = {}
    o, lse = bd.banded_fwd(q, k, v, window, scale)
    o_ref, lse_ref = bd.banded_reference(q, k, v, window, scale)
    torch.cuda.synchronize()
    errs["banded_fwd"] = max(check("o_band", o, o_ref), check("lse", lse, lse_ref))
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, dout, lse, delta, window, scale)
    dq = bd.banded_bwd_dq(*args)
    torch.cuda.synchronize()
    errs["banded_bwd_dq"] = check("dq", dq, bd.banded_bwd_dq_reference(*args))
    dk, dv = bd.banded_bwd_dkdv(*args)
    dk_ref, dv_ref = bd.banded_bwd_dkdv_reference(*args)
    torch.cuda.synchronize()
    errs["banded_bwd_dkdv"] = max(check("dk", dk, dk_ref), check("dv", dv, dv_ref))
    check_rerun("banded_bwd_dkdv", (dk, dv), bd.banded_bwd_dkdv(*args))
    check_rerun("banded_bwd_dq", (dq,), (bd.banded_bwd_dq(*args),))
    return errs


# GPT-Neo at head_dim 128 (GPT-Neo-1.3B's and 2.7B's head dim) cut to
# two heads, one global and one local layer, window 256
NEO_D128 = dict(vocab_size=512, hidden_size=256, intermediate_size=1024, num_layers=2,
                num_heads=2, max_position_embeddings=1024, window_size=256,
                attention_layers=("global", "local"))


def neo_d128_dispatch() -> None:
    """'fused' GPT-Neo at head_dim 128 on the card, bf16, one forward and
    backward: its local layer goes to K2 and its global one to K1, as the
    JAX model sends them to its banded and full kernels; its loss and
    gradients agree with the plain attention's on the same weights
    (the ring agreement's bars)."""
    import torch

    from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from acco_tpu_torch.parallel.common import make_flat_loss_fn

    cfg = GPTNeoConfig(**NEO_D128)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(12))
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids), "labels": ids}
    out = {}
    for attention in ("fused", "xla"):
        model = GPTNeoModel(cfg, dtype=torch.bfloat16, attention=attention, device="cuda")
        flat = model.init_flat(torch.Generator(device="cuda").manual_seed(13))
        model.load_flat(flat)
        reset_launch_counts()
        loss, grads = make_flat_loss_fn(model, const_len=True)(flat, batch)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        out[attention] = (float(loss), torch.cat([g.float().reshape(-1) for g in grads]),
                          launch_counts())
    (loss_f, g_f, n_f), (loss_x, g_x, _) = out["fused"], out["xla"]
    want = {"banded_fwd": 1, "banded_bwd_dq": 1, "banded_bwd_dkdv": 1, "attn_fwd": 1,
            "attn_bwd_dq": 1, "attn_bwd_dkdv": 1}
    got = {k: n_f[k] for k in want}
    rel = abs(loss_f - loss_x) / abs(loss_x)
    g_rel = float((g_f - g_x).norm() / g_x.norm())
    log(f"  head_dim {cfg.head_dim}: launches {got}; loss fused {loss_f:.6f} plain {loss_x:.6f} "
        f"(relative {rel:.3e}, bar {RING_LOSS_RTOL:g}); gradients relative L2 {g_rel:.3e} "
        f"(bar {RING_GRAD_RTOL:g})")
    if got != want:
        raise AssertionError(f"GPT-Neo at head_dim 128 launched {got}, expected {want}")
    if rel > RING_LOSS_RTOL or g_rel > RING_GRAD_RTOL:
        raise AssertionError("GPT-Neo at head_dim 128: the kernel and plain paths disagree")


def head_parity() -> None:
    """The head's float32 logits (``lm_logits``: a bf16 GEMM with float32
    output) against the float32 product of the widened bf16 operands, at
    the main paths' shape: no rounding of the logits to bf16."""
    import torch

    from acco_tpu_torch.models.layers import lm_logits

    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn(BATCH, SEQ, D_MODEL, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(50257, D_MODEL, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = False
    got = lm_logits(h, w.t())
    want = torch.matmul(h.float(), w.float().t())
    log(f"  torch.mm out_dtype: {hasattr(torch.ops.aten.mm, 'dtype')}; logits {got.dtype}")
    check("logits", got, want)
    if got.dtype != torch.float32:
        raise AssertionError(f"lm_logits returned {got.dtype}")


SLOW_CALL_MS = 100.0


def time_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 5) -> float:
    """ms per call: the median over ``windows`` windows of the mean of
    ``iters`` calls between two CUDA events, after warm-up. One window of
    a 0.1 ms kernel lasts 2 ms, and a single slow window read up to 2x a
    kernel's time in the main path's profile. A call of ``SLOW_CALL_MS``
    or more (a plain version at a long shape) is timed over one window:
    its windows' spread is a small share of it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(windows):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        means.append(start.elapsed_time(end) / iters)
        if means[0] >= SLOW_CALL_MS:  # a plain version at a long shape: one window
            break
    return statistics.median(means)


def device_ms(fn, iters: int = 10, attempts: int = 3) -> float:
    """Mean device ms per call: the CUDA kernels' own time under
    torch.profiler, for calls whose host cost (autograd) can exceed their
    device time and so would leak into an event-timed loop. A session
    whose trace holds no device activity (it happened once on the card,
    for a call that other sessions of the same run had traced) is
    profiled again, up to ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in rows)
        if total > 0:
            return total / 1e3 / iters
        log(f"  the profiler recorded no device time (attempt {attempt} of {attempts})")
    raise AssertionError("the profiler recorded no device time")


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timing(shape: dict) -> tuple[dict, dict]:
    """Per-kernel ms, plain ms, library ms and bound at ``shape``, and
    the same for the three backward kernels together."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, pad = make_inputs(shape, 7)
    window, scale = shape["window"], shape["D"] ** -0.5
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    o, lse = fa.attn_fwd(q, k, v, pad, window, scale)
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, pad, dout, lse, delta, window, scale)

    # Work this run's inputs need: causal pairs (window 0, no pad here).
    pairs = B * H * L * (L + 1) / 2
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    kv = B * Hkv * L * D * 2
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "attn_fwd": (act + 2 * kv + act + row, 4 * D * pairs),
        "attn_bwd_delta": (2 * act + row, 2 * B * H * L * D),
        "attn_bwd_dkdv": (2 * act + 2 * kv + 2 * row + 2 * kv, 8 * D * pairs),
        "attn_bwd_dq": (2 * act + 2 * kv + 2 * row + act, 6 * D * pairs),
    }
    runs = {
        "attn_fwd": (
            lambda: fa.attn_fwd(q, k, v, pad, window, scale),
            lambda: fa.attention_reference(q, k, v, pad, window, scale),
        ),
        "attn_bwd_delta": (
            lambda: fa.attn_bwd_delta(o, dout),
            lambda: fa.delta_reference(o, dout),
        ),
        "attn_bwd_dkdv": (
            lambda: fa.attn_bwd_dkdv(*args),
            lambda: fa.attn_bwd_dkdv_reference(*args),
        ),
        "attn_bwd_dq": (
            lambda: fa.attn_bwd_dq(*args),
            lambda: fa.attn_bwd_dq_reference(*args),
        ),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    # Library yardstick, timed here and never called by the port:
    # F.scaled_dot_product_attention(is_causal=True) forward (K/V repeated
    # to q's heads beforehand under GQA), and its backward (one autograd
    # call, device time: its host cost is larger than its kernels') for the
    # three backward kernels together.
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    out["attn_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kr, vr))
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = device_ms(
        lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True)
    )
    bwd = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")
    backward = {
        "ms": sum(out[n]["ms"] for n in bwd),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(
            3 * act + 2 * kv + row + act + 2 * kv, 10 * D * pairs
        )[0],
    }
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain "
        f"{backward['plain_ms']:.4f} ms  SDPA backward {sdpa_bwd_ms:.4f} ms  "
        f"bound {backward['bound_ms']:.4f} ms")
    return out, backward


def band_pairs(B: int, H: int, L: int, window: int) -> int:
    """(query, key) pairs a causal window attends: sum of min(i + 1, W)."""
    return B * H * sum(min(i + 1, window or L) for i in range(L))


def banded_timing(shape: dict) -> tuple[dict, dict]:
    """Each K2 kernel's ms, plain ms and bound at ``shape`` (scale 1.0),
    beside two yardsticks on the same inputs: the library call
    (F.scaled_dot_product_attention with a bool band mask; its backward
    as device time, as above) and the port's K1 at the same window; and
    the same for the backward (delta + dQ + dK/dV) together."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, _ = make_inputs({**shape, "qk_std": shape["D"] ** -0.25}, 8)
    window, scale = shape["window"], 1.0
    B, H, L, D = (shape[x] for x in ("B", "H", "L", "D"))
    o, lse = bd.banded_fwd(q, k, v, window, scale)
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, dout, lse, delta, window, scale)
    k1_args = (q, k, v, None, dout, lse, delta, window, scale)

    # Work this run's inputs need: the band's pairs, not L(L+1)/2.
    pairs = band_pairs(B, H, L, window)
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "banded_fwd": (4 * act + row, 4 * D * pairs),
        "banded_bwd_dq": (5 * act + 2 * row, 6 * D * pairs),
        "banded_bwd_dkdv": (6 * act + 2 * row, 8 * D * pairs),
    }
    runs = {
        "banded_fwd": (
            lambda: bd.banded_fwd(q, k, v, window, scale),
            lambda: bd.banded_reference(q, k, v, window, scale),
            lambda: fa.attn_fwd(q, k, v, None, window, scale),
        ),
        "banded_bwd_dq": (
            lambda: bd.banded_bwd_dq(*args),
            lambda: bd.banded_bwd_dq_reference(*args),
            lambda: fa.attn_bwd_dq(*k1_args),
        ),
        "banded_bwd_dkdv": (
            lambda: bd.banded_bwd_dkdv(*args),
            lambda: bd.banded_bwd_dkdv_reference(*args),
            lambda: fa.attn_bwd_dkdv(*k1_args),
        ),
    }
    out = {}
    for name, (kernel, plain, k1) in runs.items():
        ms, k1_ms, plain_ms = time_ms(kernel), time_ms(k1), time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "k1_ms": k1_ms}
    i = torch.arange(L, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    out["banded_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, scale=scale)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    y = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=band, scale=scale)
    sdpa_bwd_ms = device_ms(
        lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True)
    )
    delta_ms = time_ms(lambda: fa.attn_bwd_delta(o, dout))
    bwd = ("banded_bwd_dq", "banded_bwd_dkdv")
    backward = {
        "ms": delta_ms + sum(out[n]["ms"] for n in bwd),
        "k1_ms": delta_ms + sum(out[n]["k1_ms"] for n in bwd),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(8 * act + row, 10 * D * pairs)[0],
    }
    log(f"  band pairs {pairs}")
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  K1 at window {window} {r['k1_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  K1 {backward['k1_ms']:.4f} ms  "
        f"plain {backward['plain_ms']:.4f} ms  SDPA backward {sdpa_bwd_ms:.4f} ms  "
        f"bound {backward['bound_ms']:.4f} ms")
    return out, backward


def flash_plain(name: str, q, k, v, seg, *bwd, scale: float):
    """K5's plain version of kernel ``name``; at L >= 4096 one KV head
    (with its n_rep q heads) at a time, since heads are independent and
    the whole [B, H, L, L] float32 scores would take tens of GB."""
    import torch

    from acco_tpu_torch.ops import flash_attention as fl

    fn = {"flash_fwd": fl.flash_reference, "flash_bwd_dkdv": fl.flash_bwd_dkdv_reference,
          "flash_bwd_dq": fl.flash_bwd_dq_reference}[name]
    Hkv = k.shape[1]
    n_rep = q.shape[1] // Hkv
    if q.shape[2] < 4096:
        return fn(q, k, v, seg, *bwd, scale)
    outs = []
    for h in range(Hkv):
        qh, kvh = slice(h * n_rep, (h + 1) * n_rep), slice(h, h + 1)
        outs.append(fn(q[:, qh], k[:, kvh], v[:, kvh], seg, *(t[:, qh] for t in bwd), scale))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def flash_parity(shape: dict, seed: int) -> dict:
    """Every K5 kernel against its plain version; returns max errors. The
    backward kernels and their plain versions get the kernel forward's O
    and LSE and the kernel delta."""
    import torch

    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, seg = make_inputs(shape, seed)
    scale = shape["D"] ** -0.5
    f32 = q.dtype == torch.float32

    def tol(name):
        return F32_TOL if f32 else TOL[name]

    errs = {}
    o, lse = fl.flash_fwd(q, k, v, seg, scale)
    o_ref, lse_ref = flash_plain("flash_fwd", q, k, v, seg, scale=scale)
    torch.cuda.synchronize()
    errs["flash_fwd"] = max(check("o", o, o_ref, tol("o")), check("lse", lse, lse_ref, tol("lse")))
    del o_ref, lse_ref
    delta = fl.flash_bwd_delta(o, dout)
    torch.cuda.synchronize()
    errs["flash_bwd_delta"] = check("delta", delta, fa.delta_reference(o, dout), tol("delta"))
    bwd = (dout, lse, delta)
    dk, dv = fl.flash_bwd_dkdv(q, k, v, seg, *bwd, scale)
    dk_ref, dv_ref = flash_plain("flash_bwd_dkdv", q, k, v, seg, *bwd, scale=scale)
    torch.cuda.synchronize()
    errs["flash_bwd_dkdv"] = max(check("dk", dk, dk_ref, tol("dk")),
                                 check("dv", dv, dv_ref, tol("dv")))
    dq = fl.flash_bwd_dq(q, k, v, seg, *bwd, scale)
    dq_ref = flash_plain("flash_bwd_dq", q, k, v, seg, *bwd, scale=scale)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = check("dq", dq, dq_ref, tol("dq"))
    del dk_ref, dv_ref, dq_ref
    check_rerun("flash_bwd_dkdv", (dk, dv), fl.flash_bwd_dkdv(q, k, v, seg, *bwd, scale))
    check_rerun("flash_bwd_dq", (dq,), (fl.flash_bwd_dq(q, k, v, seg, *bwd, scale),))
    del q, k, v, dout, o, dk, dv, dq
    torch.cuda.empty_cache()
    return errs


def flash_timing(shape: dict) -> tuple[dict, dict]:
    """Each K5 kernel's ms, plain ms, library ms and bound at ``shape``
    (causal, no segment ids: the main path's case), and the same for the
    backward (delta + dK/dV + dQ) together. Library: SDPA on K/V repeated
    to q's heads beforehand (``is_causal=True``), its backward as one
    autograd call's device time, as for K1."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, seg = make_inputs(shape, 9)
    scale = shape["D"] ** -0.5
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    o, lse = fl.flash_fwd(q, k, v, seg, scale)
    delta = fl.flash_bwd_delta(o, dout)
    bwd = (dout, lse, delta)
    big = L >= 4096  # the plain version then runs one KV head at a time

    pairs = B * H * L * (L + 1) / 2  # causal pairs, no segment ids
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    kv = B * Hkv * L * D * 2
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "flash_fwd": (act + 2 * kv + act + row, 4 * D * pairs),
        "flash_bwd_delta": (2 * act + row, 2 * B * H * L * D),
        "flash_bwd_dkdv": (2 * act + 2 * kv + 2 * row + 2 * kv, 8 * D * pairs),
        "flash_bwd_dq": (2 * act + 2 * kv + 2 * row + act, 6 * D * pairs),
    }
    runs = {
        "flash_fwd": (lambda: fl.flash_fwd(q, k, v, seg, scale),
                      lambda: flash_plain("flash_fwd", q, k, v, seg, scale=scale)),
        "flash_bwd_delta": (lambda: fl.flash_bwd_delta(o, dout),
                            lambda: fa.delta_reference(o, dout)),
        "flash_bwd_dkdv": (lambda: fl.flash_bwd_dkdv(q, k, v, seg, *bwd, scale),
                           lambda: flash_plain("flash_bwd_dkdv", q, k, v, seg, *bwd,
                                               scale=scale)),
        "flash_bwd_dq": (lambda: fl.flash_bwd_dq(q, k, v, seg, *bwd, scale),
                         lambda: flash_plain("flash_bwd_dq", q, k, v, seg, *bwd, scale=scale)),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, iters=5 if big else 20)
        plain_ms = time_ms(plain, iters=1, warmup=1, windows=3) if big else time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
        torch.cuda.empty_cache()
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    out["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kr, vr))
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True))
    del qg, kg, vg, y, kr, vr
    bwd_names = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
    backward = {
        "ms": sum(out[n]["ms"] for n in bwd_names),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd_names),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(3 * act + 2 * kv + row + act + 2 * kv, 10 * D * pairs)[0],
    }
    log(f"  attended pairs {pairs:.6g}")
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain {backward['plain_ms']:.4f} ms"
        f"  SDPA backward {sdpa_bwd_ms:.4f} ms  bound {backward['bound_ms']:.4f} ms")
    log(f"  forward + backward  kernel {out['flash_fwd']['ms'] + backward['ms']:.4f} ms  SDPA "
        f"{out['flash_fwd']['library_ms'] + sdpa_bwd_ms:.4f} ms")
    del q, k, v, dout, o, lse, delta
    torch.cuda.empty_cache()
    return out, backward


def block_variant(shape: dict, variant: str):
    """(diag, query positions, key positions, window) of a K4 variant."""
    import torch

    from acco_tpu_torch.ops.ring_attention import zigzag_positions

    if variant in ("full", "diag"):
        return variant == "diag", None, None, 0
    if variant.startswith("rect w"):  # the queries at the last Lq of the Lk positions
        Lq, Lk = shape["L"], shape.get("Lk", shape["L"])
        pos = torch.arange(Lk, dtype=torch.int32, device="cuda")
        return False, pos[Lk - Lq:].contiguous(), pos, int(variant[len("rect w"):])
    q_rank, kv_rank, length, ranks, window = {**ZZ_NEO, **ZZ_SMALL, **ZZ_MID}[variant]
    if length // ranks != shape["L"]:
        raise ValueError(f"{variant}: a chunk of {length // ranks}, shape has L {shape['L']}")
    pos = [zigzag_positions(length, ranks, r).to(torch.int32).cuda() for r in (q_rank, kv_rank)]
    return False, pos[0], pos[1], window


def make_block_inputs(shape: dict, seed: int):
    """q, k, v in the shape's dtype and random float32 cotangents g [B, H,
    L, D], r_m, r_l [B, H, L] (std 1) for K4's three outputs, which
    ``block_cotangents`` scales (k and v have ``Lk`` rows where the shape
    names it, else L). With ``ties``, three keys of every KV head are one
    vector u and every query leans on u, so each row that sees them has
    its max three times."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    Lk = shape.get("Lk", L)
    dtype = getattr(torch, shape.get("dtype", "bfloat16"))
    std = shape.get("qk_std", 1.0)

    def randn(*size, s=1.0):
        return torch.randn(*size, generator=g, device="cuda") * s

    q, k, v = randn(B, H, L, D, s=std), randn(B, Hkv, Lk, D, s=std), randn(B, Hkv, Lk, D)
    if shape.get("ties"):
        u = randn(D, s=std)
        q = q + u
        k[:, :, [3, 4, 5]] = 2 * u
    cot = (randn(B, H, L, D), randn(B, H, L), randn(B, H, L))
    return (q.to(dtype), k.to(dtype), v.to(dtype)), cot


def block_cotangents(cot, l):
    """(dO, dm, dl) at the scale the ring's merge gives them: the partial
    o is unnormalised (|o| grows with the row sum l), and the merge's
    cotangents on o and l carry a 1 / l, on m none: dO = g / l, dl = r_l /
    l, dm = r_m, random so that the tie term (dm - sum p dp) / cnt carries
    weight."""
    g, r_m, r_l = cot
    inv = 1.0 / l
    return (g * inv[..., None]).contiguous(), r_m.contiguous(), (r_l * inv).contiguous()


def block_plain(fn, q, k, v, *rows, **kw):
    """K4's plain version ``fn`` (forward or backward); at L >= 4096 one KV
    head (with its n_rep q heads) at a time, as flash_plain does."""
    import torch

    if q.shape[2] < 4096:
        return fn(q, k, v, *rows, **kw)
    n_rep = q.shape[1] // k.shape[1]
    outs = []
    for h in range(k.shape[1]):
        qh, kvh = slice(h * n_rep, (h + 1) * n_rep), slice(h, h + 1)
        outs.append(fn(q[:, qh], k[:, kvh], v[:, kvh], *(t[:, qh] for t in rows), **kw))
        torch.cuda.empty_cache()
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=1)
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def block_grad_terms(q, k, v, m, do, dm, dl, **kw):
    """For each element of K4's dQ, dK and dV, a bound on the largest
    product in its sum, from the plain version's dS and P: dq[i, d] sums
    scale ds[i, j] k[j, d] over keys, bounded by scale max_j |ds[i, j]|
    max_j |k[j, d]|; dk[j, d] and dv[j, d] likewise over the rows (and the
    q heads) of the KV head."""
    from acco_tpu_torch.ops import block_attention as bl

    def terms(q, k, v, m, do, dm, dl, **kw):
        p, ds, kr, scale = bl._block_bwd_terms(q, k, v, m, do, dm, dl, kw["diag"], kw["q_pos"],
                                               kw["kv_pos"], kw["window"], kw["scale"])
        B, H = q.shape[:2]
        Hkv = k.shape[1]

        def per_kv(x):  # [B, H, n] -> [B, Hkv, n], the max over each KV head's q heads
            return x.view(B, Hkv, H // Hkv, -1).amax(2)

        a = ds.abs()
        t_dq = scale * a.amax(-1, keepdim=True) * kr.float().abs().amax(2, keepdim=True)
        t_dk = scale * per_kv(a.amax(2))[..., None] * per_kv(q.float().abs().amax(2))[:, :, None]
        t_dv = per_kv(p.amax(2))[..., None] * per_kv(do.abs().amax(2))[:, :, None]
        return t_dq, t_dk, t_dv

    return block_plain(terms, q, k, v, m, do, dm, dl, **kw)


def check_term(name: str, got, want, term) -> float:
    """|got - want| <= atol + rtol |want| + 2^-6 term, elementwise (TOL's
    bar plus two bf16 steps of the element's largest product)."""
    import torch

    atol, rtol = TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = atol + rtol * want.abs() + 2 ** -6 * term
    max_err = float(err.max())
    used = float((err / tol).max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {atol:g} + {rtol:g}*|ref| + 2^-6*term; "
        f"median term {float(term.median()):.3e}; worst err/tol {used:.3f})")
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: {int((err > tol).sum())} elements outside tolerance "
                             f"(max abs err {max_err:.3e}, worst err/tol {used:.3f})")
    return max_err


def block_parity(shape: dict, seed: int, variants) -> dict:
    """Every K4 kernel against its plain version, per variant; returns max
    errors. The row-statistics kernel and its plain version take the same
    inputs (the kernel forward's o, l, cnt); the dK/dV and dQ kernels and
    the plain backward each take their own forward's m, since eq = (s ==
    m) needs the s that its own products give."""
    import torch

    from acco_tpu_torch.ops import block_attention as bl

    (q, k, v), cot = make_block_inputs(shape, seed)
    scale = shape.get("scale", shape["D"] ** -0.5)
    f32 = q.dtype == torch.float32

    def tol(name):
        return F32_TOL if f32 else TOL[name]

    errs = {}
    for variant in variants:
        diag, qp, kp, window = block_variant(shape, variant)
        mode = bl._mode(diag, qp)
        fwd_name = "blk_fwd_" + ("pos" if qp is not None else variant)
        kw = dict(diag=diag, q_pos=qp, kv_pos=kp, window=window, scale=scale)
        log(f"  {variant}")
        o, m, l, cnt = bl.blk_fwd(q, k, v, mode, qp, kp, window, scale)
        o_r, m_r, l_r, cnt_r = block_plain(bl.block_fwd_reference, q, k, v, **kw)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        if not torch.equal(cnt, cnt_r):
            raise AssertionError(f"cnt: {int((cnt != cnt_r).sum())} rows count other ties")
        # o is unnormalised: compared as o / l_ref, the normalised output's scale
        inv = 1.0 / l_r[..., None]
        e = max(check("o", o * inv, o_r * inv, tol("o")), check("blk_m", m, m_r, tol("blk_m")),
                check("blk_l", l, l_r, tol("blk_l")))
        do, dm, dl = block_cotangents(cot, l_r)
        errs[fwd_name] = max(errs.get(fwd_name, 0.0), e)
        log(f"  rows fully masked: {int((m == -1e9).sum())}; rows with tied maxima: "
            f"{int((cnt > 1).sum())}")
        del o_r, l_r, cnt_r
        do_t = do.to(q.dtype).contiguous()  # as the autograd backward passes it
        c = bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        e = check("blk_c", c, bl.block_rowc_reference(o, do_t, dm, dl, l, cnt), tol("blk_c"))
        errs["blk_bwd_rowc"] = max(errs.get("blk_bwd_rowc", 0.0), e)
        args = (q, k, v, mode, qp, kp, window, scale, do_t, m, dl, c)
        dk, dv = bl.blk_bwd_dkdv(*args)
        dq = bl.blk_bwd_dq(*args)
        check_rerun("blk_bwd_dkdv", (dk, dv), bl.blk_bwd_dkdv(*args))
        check_rerun("blk_bwd_dq", (dq,), (bl.blk_bwd_dq(*args),))
        grads = block_plain(bl.block_bwd_reference, q, k, v, m_r, do, dm, dl, **kw)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        if f32:  # no rounding on either side: the float32 bar alone
            e = {n: check(n, g, r, F32_TOL) for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                                                 grads)}
        else:  # a random dm makes single products of dS large: their bf16 steps count
            terms = block_grad_terms(q, k, v, m_r, do, dm, dl, **kw)
            e = {n: check_term(n, g, r, t) for n, g, r, t in zip(("dq", "dk", "dv"),
                                                                  (dq, dk, dv), grads, terms)}
            del terms
        errs["blk_bwd_dkdv"] = max(errs.get("blk_bwd_dkdv", 0.0), e["dk"], e["dv"])
        errs["blk_bwd_dq"] = max(errs.get("blk_bwd_dq", 0.0), e["dq"])
        del o, dq, dk, dv, grads, do, dm, dl
        torch.cuda.empty_cache()
    return errs


def block_timing(shape: dict, variants, seed: int) -> dict:
    """Each K4 kernel's ms, plain ms and bound at ``shape``, per variant,
    beside SDPA on the same attended pairs (no mask for 'full',
    ``is_causal`` for 'diag', the bool mask for a positional variant): a
    reference time for the same work, not the same function (SDPA returns
    the normalised output and no m or l); its backward as one autograd
    call's device time. Keys '<kernel>/<variant>'."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import block_attention as bl

    (q, k, v), cot = make_block_inputs(shape, seed)
    scale = shape.get("scale", shape["D"] ** -0.5)
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    big = L >= 4096  # the plain version then runs one KV head at a time
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    out = {}
    for variant in variants:
        diag, qp, kp, window = block_variant(shape, variant)
        mode = bl._mode(diag, qp)
        kw = dict(diag=diag, q_pos=qp, kv_pos=kp, window=window, scale=scale)
        mask = bl.block_mask(L, L, diag, qp, kp, window, q.device)
        pairs = B * H * (L * L if mask is None else int(mask.sum()))
        # the kernels take the positions with their spans, made once a call
        # of block_attention_partial (the plain version: the positions)
        qs, ks = (None, None) if qp is None else map(bl.positions_with_spans, (qp, kp))
        o, m, l, cnt = bl.blk_fwd(q, k, v, mode, qs, ks, window, scale)
        do, dm, dl = block_cotangents(cot, l)
        do_t = do.to(q.dtype).contiguous()
        c = bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt)
        args = (q, k, v, mode, qs, ks, window, scale, do_t, m, dl, c)
        bwd = (q, k, v, m, do, dm, dl)
        act = B * H * L * D * q.element_size()  # q, dO or dQ
        kv = B * Hkv * L * D * k.element_size()
        o_bytes = B * H * L * D * 4  # the float32 partial o
        row = B * H * L * 4  # a float32 [B, H, L]
        work = {  # bytes (inputs read once, outputs written once), operations
            "blk_fwd": (act + 2 * kv + o_bytes + 3 * row, 4 * D * pairs),
            "blk_bwd_rowc": (o_bytes + act + 4 * row + row, 2 * B * H * L * D),
            "blk_bwd_dkdv": (2 * act + 2 * kv + 3 * row + 2 * kv, 8 * D * pairs),
            "blk_bwd_dq": (2 * act + 2 * kv + 3 * row + act, 6 * D * pairs),
        }
        runs = {
            "blk_fwd": (lambda: bl.blk_fwd(q, k, v, mode, qs, ks, window, scale),
                        lambda: block_plain(bl.block_fwd_reference, q, k, v, **kw)),
            "blk_bwd_rowc": (lambda: bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt),
                             lambda: bl.block_rowc_reference(o, do_t, dm, dl, l, cnt)),
            "blk_bwd_dkdv": (lambda: bl.blk_bwd_dkdv(*args),
                             lambda: block_plain(bl.block_bwd_dkdv_reference, *bwd, **kw)),
            "blk_bwd_dq": (lambda: bl.blk_bwd_dq(*args),
                           lambda: block_plain(bl.block_bwd_dq_reference, *bwd, **kw)),
        }
        sdpa_kw = {"full": {}, "diag": {"is_causal": True}}.get(variant, {"attn_mask": mask})
        for name, (kernel, plain) in runs.items():
            ms = time_ms(kernel, iters=5 if big else 20)
            plain_ms = (time_ms(plain, iters=1, warmup=1, windows=3) if big
                        else time_ms(plain, iters=5))
            b_ms, b_by = bound_ms(*work[name])
            out[f"{name}/{variant}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                        "bound_by": b_by, "library_ms": None}
            torch.cuda.empty_cache()
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, scale=scale,
                                                                  **sdpa_kw))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kr, vr))
        y = F.scaled_dot_product_attention(qg, kg, vg, scale=scale, **sdpa_kw)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(y, (qg, kg, vg), do_t,
                                                         retain_graph=True))
        out[f"blk_fwd/{variant}"]["sdpa_ms"] = sdpa_fwd
        for name in ("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"):
            out[f"{name}/{variant}"]["sdpa_bwd_ms"] = sdpa_bwd
        del qg, kg, vg, y, o, m, l, cnt, c, do, do_t
        torch.cuda.empty_cache()
        log(f"  {variant}: attended pairs {pairs:.6g}")
        for name in runs:
            r = out[f"{name}/{variant}"]
            log(f"  {name:13s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        bwd_ms = sum(out[f"{n}/{variant}"]["ms"] for n in ("blk_bwd_rowc", "blk_bwd_dkdv",
                                                           "blk_bwd_dq"))
        log(f"  SDPA on the same pairs: forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms; "
            f"K4 forward {out[f'blk_fwd/{variant}']['ms']:.4f}, backward {bwd_ms:.4f} ms")
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    return out


def make_ce_inputs(shape: dict, seed: int):
    """K3's inputs on the card, bf16: hidden rows (std 1), the head as the
    [V, D] table (std 0.02, the models' init), int32 targets below v_real
    (0 on ignored rows, as fused_ce_loss maps them), and the cotangents
    of the mean loss that fused_ce_loss's outer arithmetic gives them
    (with ``softmax_only``: d_lse random per row, d_tl = d_sl = 0)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    N, D, V, v_real = (shape[k] for k in ("N", "D", "V", "v_real"))
    h = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(V, D, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    tgt = torch.randint(0, v_real, (N,), generator=g, device="cuda")
    mask = (torch.rand(N, generator=g, device="cuda") >= shape["ignore"]).float()
    if shape.get("seq"):
        mask[shape["seq"] - 1::shape["seq"]] = 0.0
    tgt = torch.where(mask > 0, tgt, torch.zeros_like(tgt)).to(torch.int32)
    ls, denom = shape["smoothing"], mask.sum().clamp(min=1.0)
    cot = (mask / denom, -(1.0 - ls) * mask / denom, -ls * mask / (denom * v_real))
    if shape.get("softmax_only"):
        d_lse = torch.randn(N, generator=g, device="cuda") * mask / denom
        cot = (d_lse, torch.zeros_like(d_lse), torch.zeros_like(d_lse))
    return h, w, tgt, v_real, mask, tuple(c.contiguous() for c in cot)


def ce_parity(shape: dict, seed: int) -> dict:
    """K3's four kernels against their plain versions; returns max errors.
    dp and its plain version get the kernel's lse; dH and dW take the
    kernel's dp and are held against the plain products of the plain dp.
    A second run of dp, dH and dW must give the same bits."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    h, w, tgt, v_real, _, cot = make_ce_inputs(shape, seed)
    V = w.shape[0]
    errs = {}
    lse, tl, sl = fc.ce_fwd(h, w, tgt, v_real)
    ref = fc.ce_fwd_reference(h, w, tgt, v_real)
    torch.cuda.synchronize()
    logits = fc._logits(h, w, v_real)[0]
    mass = logits.abs_()[:, :v_real].sum(-1)
    del logits
    errs["ce_fwd"] = max(check("ce_lse", lse, ref[0]), check("ce_tl", tl, ref[1]),
                         check_mass("ce_sl", sl, ref[2], mass))
    args = (h, w, tgt, v_real, lse, *cot)
    term_dh, term_dw = ce_grad_terms(h, w, args)
    dp = fc.ce_bwd_dp(*args)
    torch.cuda.synchronize()
    dp_ref = fc.ce_bwd_dp_reference(*args)
    errs["ce_bwd_dp"] = check_dp("ce_dp", dp, dp_ref, fc.dlogits_f32(*args), V)
    dh = fc.ce_bwd_dh(dp, w)
    torch.cuda.synchronize()
    errs["ce_bwd_dh"] = check_elementwise("ce_dh", dh, fc.ce_bwd_dh_reference(dp_ref, w), term_dh)
    dw = fc.ce_bwd_dw(dp, h, V)
    torch.cuda.synchronize()
    errs["ce_bwd_dw"] = check_elementwise("ce_dw", dw, fc.ce_bwd_dw_reference(dp_ref, h, V),
                                          term_dw)
    dp2 = fc.ce_bwd_dp(*args)
    same = (torch.equal(dp2, dp), torch.equal(fc.ce_bwd_dh(dp2, w), dh),
            torch.equal(fc.ce_bwd_dw(dp2, h, V), dw))
    log(f"  a second run of dp, dH, dW bit-identical: {same}")
    if not all(same):
        raise AssertionError(f"K3's backward is not deterministic: {same}")
    del h, w, ref, dp, dp2, dp_ref, dh, dw, term_dh, term_dw
    torch.cuda.empty_cache()
    return errs


def ce_chunked_parity(shape: dict, seed: int, n_chunks: int = 3) -> dict:
    """K3's bf16 backward through ``LmHeadCE`` with a dp cap that cuts the
    rows into ``n_chunks`` chunks of a multiple of 128 rows, the last
    ragged (dW summed in the float32 buffer: modes 1, 2, 3): dH bit-equal
    to the one-chunk run's (each row's dp and products do not depend on
    the chunk), dW against the plain chunked backward at the same cap."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    h, w, tgt, v_real, _, cot = make_ce_inputs(shape, seed)
    N, V = h.shape[0], w.shape[0]
    rows = -(-N // n_chunks)
    cap = 2 * fc.padded_vocab(V) * -(-rows // 128) * 128
    plan = fc.dp_plan(N, V, cap)
    if plan.n_chunks != n_chunks or not plan.dw_f32 or N % plan.chunk_rows == 0:
        raise AssertionError(f"cap {cap} gives {plan}, not {n_chunks} chunks, the last ragged")

    def grads(cap_bytes):
        hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
        out = fc.LmHeadCE.apply(hg, wg, tgt, v_real, cap_bytes)
        return torch.autograd.grad(out, (hg, wg), cot), out[0].detach()

    (dh1, _), lse = grads(fc.DP_CAP_BYTES)
    reset_launch_counts()
    dh, dw = grads(cap)[0]
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if k.startswith("ce_")}
    log(f"  {plan}; launches {launches}")
    if launches != {"ce_fwd": 1, **dict.fromkeys(("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw"),
                                                   n_chunks)}:
        raise AssertionError(f"the chunked backward launched {launches}")
    if not torch.equal(dh, dh1):
        raise AssertionError("the chunked dH differs from the one-chunk dH")
    log("  dH bit-equal to the one-chunk run's")
    args = (h, w, tgt, v_real, lse, *cot)
    _, term_dw = ce_grad_terms(h, w, args)
    ref_dw = fc.lm_head_ce_backward_reference(*args, cap_bytes=cap, need_h=False)[1]
    err = check_elementwise("ce_dw", dw, ref_dw, term_dw)
    del h, w, dh, dh1, dw, ref_dw, term_dw
    torch.cuda.empty_cache()
    return {"ce_bwd_dw": err}


def ce_timing(shape: dict, batch: int, seq: int) -> tuple[dict, dict, dict]:
    """K3's kernels at a head of ``batch`` x ``seq`` rows (the last of each
    sequence ignored): kernel ms, plain ms and bound, with their errors
    against the plain versions at this shape; and the loss as a whole
    (``fused_ce_loss`` forward, forward + backward, peak memory) beside the
    port's materialized head and CE (``layers.lm_logits`` +
    ``causal_lm_loss``) on the same inputs."""
    import torch

    from acco_tpu_torch.models.layers import lm_logits
    from acco_tpu_torch.ops import fused_ce as fc
    from acco_tpu_torch.ops.losses import IGNORE_INDEX, causal_lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    h, w, tgt, v_real, mask, cot = make_ce_inputs(shape, 11)
    N, D, V = (shape[k] for k in ("N", "D", "V"))
    lse, tl, sl = fc.ce_fwd(h, w, tgt, v_real)
    args = (h, w, tgt, v_real, lse, *cot)
    term_dh, term_dw = ce_grad_terms(h, w, args)
    dp = fc.ce_bwd_dp(*args)
    dp_ref = fc.ce_bwd_dp_reference(*args)
    errs = {"ce_fwd": check("ce_lse", lse, fc.ce_fwd_reference(h, w, tgt, v_real)[0]),
            "ce_bwd_dp": check_dp("ce_dp", dp, dp_ref, fc.dlogits_f32(*args), V)}
    errs["ce_bwd_dh"] = check_elementwise("ce_dh", fc.ce_bwd_dh(dp, w),
                                          fc.ce_bwd_dh_reference(dp_ref, w), term_dh)
    errs["ce_bwd_dw"] = check_elementwise("ce_dw", fc.ce_bwd_dw(dp, h, V),
                                          fc.ce_bwd_dw_reference(dp_ref, h, V), term_dw)
    del term_dh, term_dw, dp_ref
    torch.cuda.empty_cache()
    vp = fc.padded_vocab(V)
    rows, hb, wb, dpb = N * 4, N * D * 2, V * D * 2, N * vp * 2  # float32 [N]; bf16 h, w, dp
    ops = 2 * N * D * V
    work = {  # bytes (inputs read once, outputs written once), operations
        "ce_fwd": (hb + wb + rows + 3 * rows, ops),
        "ce_bwd_dp": (hb + wb + rows + 4 * rows + dpb, ops),
        "ce_bwd_dh": (dpb + wb + hb, ops),
        "ce_bwd_dw": (dpb + hb + wb, ops),
    }
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    runs = {
        "ce_fwd": (lambda: fc.ce_fwd(h, w, tgt, v_real),
                   lambda: fc.ce_fwd_reference(h, w, tgt, v_real)),
        "ce_bwd_dp": (lambda: fc.ce_bwd_dp(*args, out=dp), lambda: fc.ce_bwd_dp_reference(*args)),
        "ce_bwd_dh": (lambda: fc.ce_bwd_dh(dp, w, out=dh), lambda: fc.ce_bwd_dh_reference(dp, w)),
        "ce_bwd_dw": (lambda: fc.ce_bwd_dw(dp, h, V, out=dw),
                      lambda: fc.ce_bwd_dw_reference(dp, h, V)),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms, plain_ms = time_ms(kernel, iters=10), time_ms(plain, iters=2, windows=3)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
        torch.cuda.empty_cache()
    del dp, dh, dw

    # the whole loss on [B, L, D] hidden states and B L labels whose
    # shift gives the targets above, through K3 and through the
    # materialized head
    h3 = h.view(batch, seq, D)
    labels = torch.full((batch, seq), IGNORE_INDEX, dtype=torch.long, device="cuda")
    labels[:, 1:] = torch.where(mask > 0, tgt.long(), IGNORE_INDEX).view(batch, seq)[:, :-1]
    hg, wg = h3.detach().requires_grad_(True), w.detach().requires_grad_(True)

    def fused(grad: bool):
        loss = fc.fused_ce_loss(hg, wg.t(), labels)
        return torch.autograd.grad(loss, (hg, wg)) if grad else loss

    def materialized(grad: bool):
        loss = causal_lm_loss(lm_logits(hg, wg.t()), labels)
        return torch.autograd.grad(loss, (hg, wg)) if grad else loss

    whole = {}
    for name, fn in (("fused", fused), ("materialized", materialized)):
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fn(False), iters=5, windows=3)
        step_ms = time_ms(lambda: fn(True), iters=5, windows=3)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(True)
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        peak = torch.cuda.max_memory_allocated() - base
        whole[name] = {"forward_ms": fwd_ms, "backward_ms": step_ms - fwd_ms,
                       "step_ms": step_ms, "peak_bytes": peak}
        torch.cuda.empty_cache()
    with torch.no_grad():
        loss_f, loss_m = float(fused(False)), float(materialized(False))
    log(f"  loss: K3 {loss_f:.6f}  materialized {loss_m:.6f}")
    if abs(loss_f - loss_m) > 1e-5 * abs(loss_m):
        raise AssertionError("K3's loss and the materialized loss disagree")
    out["ce_fwd"]["materialized_ms"] = whole["materialized"]["forward_ms"]
    for name in ("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw"):  # the materialized backward makes all
        out[name]["materialized_ms"] = whole["materialized"]["backward_ms"]
    bwd = ("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw")
    backward = {
        "ms": sum(out[k]["ms"] for k in bwd),
        "plain_ms": sum(out[k]["plain_ms"] for k in bwd),
        "materialized_ms": whole["materialized"]["backward_ms"],
        "bound_ms": sum(out[k]["bound_ms"] for k in bwd),
    }
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"materialized {r['materialized_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; kernel / bound {r['ms'] / r['bound_ms']:.2f}, "
            f"{ops / r['ms'] / 1e9:.1f} TFLOP/s)")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain {backward['plain_ms']:.4f} ms"
        f"  materialized {backward['materialized_ms']:.4f} ms  bound {backward['bound_ms']:.4f} ms")
    log(f"  K3 forward + backward {out['ce_fwd']['ms'] + backward['ms']:.4f} ms against the "
        f"materialized head and CE's {whole['materialized']['step_ms']:.4f} ms")
    for name, r in whole.items():
        log(f"  whole loss, {name:12s}: forward {r['forward_ms']:.4f} ms  backward "
            f"{r['backward_ms']:.4f} ms  step {r['step_ms']:.4f} ms  peak above inputs "
            f"{r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.3f} GiB)")
    del h, w, hg, wg, h3
    torch.cuda.empty_cache()
    return out, {**backward, "whole": whole}, errs


def _launch_tables():
    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import block_attention as bl
    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa
    from acco_tpu_torch.ops import fused_ce as fc

    return fa, bd, fc, fl, bl


def reset_launch_counts() -> None:
    for module in _launch_tables():
        module.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for module in _launch_tables():
        out.update(module.LAUNCHES)
    return out


class HeadLogitsCalls:
    """Counts the models' calls of the materialized head
    (``layers.lm_logits``, as models/llama.py and models/gpt_neo.py import
    it) while the context is open: the fused-CE path must make none. The
    count is a launch table of ``compile.graphs.counting``: a captured
    round's replay adds the calls its capture made."""

    @property
    def count(self) -> int:
        return self.calls["lm_logits"]

    def __enter__(self):
        from acco_tpu_torch.compile.graphs import counting
        from acco_tpu_torch.models import gpt_neo, llama
        from acco_tpu_torch.parallel import pp

        self.calls, self.saved = {"lm_logits": 0}, []
        self.counting = counting(self.calls)
        self.counting.__enter__()
        for module in (llama, gpt_neo, pp):
            original = module.lm_logits

            def counted(h, w, _original=original):
                self.calls["lm_logits"] += 1
                return _original(h, w)

            self.saved.append((module, original))
            module.lm_logits = counted
        return self

    def __exit__(self, *exc):
        for module, original in self.saved:
            module.lm_logits = original
        self.counting.__exit__(*exc)


class BlockWindows:
    """Counts K4's positional forward launches by window while the
    context is open (the windowed ring's layers: 0 = global)."""

    def __enter__(self):
        from acco_tpu_torch.compile.graphs import counting
        from acco_tpu_torch.ops import block_attention as bl

        self.module, self.original, self.counts = bl, bl.blk_fwd, {}
        self.counting = counting(self.counts)  # replays add what their capture counted
        self.counting.__enter__()

        def counted(q, k, v, mode, q_pos, kv_pos, window, scale):
            if mode == bl.MODES["pos"]:
                self.counts[window] = self.counts.get(window, 0) + 1
            return self.original(q, k, v, mode, q_pos, kv_pos, window, scale)

        bl.blk_fwd = counted
        return self

    def __exit__(self, *exc):
        self.module.blk_fwd = self.original
        self.counting.__exit__(*exc)


# Each main path: its model and extra overrides, its shape (batch, seq,
# d_model), its layers' windows (0 = global), the parameters outside any
# matmul (an untied embedding table), the fused loss it must resolve to,
# the launches per microbatch of every kernel (K2 reuses K1's delta
# kernel) and the calls of the materialized head per microbatch.
_K1 = ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")
_K2 = ("banded_fwd", "banded_bwd_dq", "banded_bwd_dkdv")
_K3 = ("ce_fwd", "ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw")
_K3_F32 = ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")  # float32: dp recomputed inside dH and dW
_K5 = ("flash_fwd", "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
_K4 = ("blk_fwd_diag", "blk_fwd_full", "blk_fwd_pos", "blk_bwd_rowc", "blk_bwd_dkdv",
       "blk_bwd_dq")
_125M = dict(batch=BATCH, seq=SEQ, d_model=D_MODEL, embed_params=0)
MAIN_PATHS = {
    "llama-125M": dict(
        model="llama-125M", extra=[], **_125M, windows=[0] * LAYERS, head_logits=1,
        fused_loss=False, attention="fused",
        per_microbatch={**dict.fromkeys(_K1, 12), **dict.fromkeys(_K2 + _K3 + _K5 + _K4, 0)},
    ),
    "gptneo": dict(
        model="gptneo", extra=[], **_125M, windows=[0, NEO_WINDOW] * (LAYERS // 2),
        head_logits=1, fused_loss=False, attention="fused",
        per_microbatch={"attn_fwd": 6, "attn_bwd_delta": 12, "attn_bwd_dkdv": 6,
                        "attn_bwd_dq": 6, **dict.fromkeys(_K2, 6),
                        **dict.fromkeys(_K3 + _K5 + _K4, 0)},
    ),
    "llama-125M-fusedce": dict(
        model="llama-125M", extra=["train.fused_loss=pallas"], **_125M, windows=[0] * LAYERS,
        head_logits=0, fused_loss="pallas", attention="fused",
        per_microbatch={**dict.fromkeys(_K1, 12), **dict.fromkeys(_K2 + _K5 + _K4, 0),
                        **dict.fromkeys(_K3, 1)},
    ),
    # Llama-3-8B at full width, 2 layers, L 8192: use_pallas_attention and
    # fused_loss stay 'auto' and must resolve to K5 and K3
    "llama3-8B-L8192": dict(
        model="llama-125M", llama3=True, extra=[], batch=1, seq=LLAMA3_SEQ, d_model=4096,
        embed_params=128256 * 4096, windows=[0] * LLAMA3_LAYERS, head_logits=0,
        fused_loss="pallas", attention="flash",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K4, 0), **dict.fromkeys(_K3, 1),
                        **dict.fromkeys(_K5, LLAMA3_LAYERS)},
    ),
}
for _spec in MAIN_PATHS.values():  # no dense path reaches the vocab-parallel wrapper
    _spec["per_microbatch"]["vp_ce"] = 0
# The ring paths (context parallelism through a one-rank NCCL sequence
# group: every layout runs its self blocks, no hop): the long-context
# Llama path's model and data through the zig-zag ring (per layer two
# diagonal half-blocks and one full, 4096 rows each; K3 for the loss, as
# fused_loss 'auto' resolves under CP), and GPT-Neo-125M through the
# windowed ring (one positional block per layer, window 0 or 256; K3 as
# well). GPT-Neo-125M's position table holds 1024 positions, so its ring
# runs at L 1024 as its main path does.
RING_PATHS = {
    "llama3-8B-L8192-ring": dict(
        base="llama3-8B-L8192", batch=1, seq=LLAMA3_SEQ, d_model=4096,
        embed_params=128256 * 4096, windows=[0] * LLAMA3_LAYERS, head_logits=0,
        fused_loss="pallas", attention="ring",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K5, 0), **dict.fromkeys(_K3, 1),
                        "blk_fwd_diag": 2 * LLAMA3_LAYERS, "blk_fwd_full": LLAMA3_LAYERS,
                        "blk_fwd_pos": 0,
                        **dict.fromkeys(("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
                                        3 * LLAMA3_LAYERS)},
    ),
    "gptneo-ring": dict(
        base="gptneo", **_125M, windows=[0, NEO_WINDOW] * (LAYERS // 2), head_logits=0,
        fused_loss="pallas", attention="ring",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K5, 0), **dict.fromkeys(_K3, 1),
                        "blk_fwd_diag": 0, "blk_fwd_full": 0, "blk_fwd_pos": LAYERS,
                        **dict.fromkeys(("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
                                        LAYERS)},
        pos_windows={0: LAYERS // 2, NEO_WINDOW: LAYERS // 2},
    ),
}
for _spec in RING_PATHS.values():
    _spec["per_microbatch"]["vp_ce"] = 0
# The dp paths (data parallelism through a one-rank NCCL dp group handed
# to build_trainer: the count all-reduce and ZeRO-1's reduce-scatter,
# all-gather and norm all-reduce on process groups of their own, identities
# at one rank): the Llama-125M path's model and data with train=acco,
# train=dpu and the ddp baseline (no seed round: 6 microbatches).
DP_PATHS = {f"llama-125M-dp-{m}": dict(MAIN_PATHS["llama-125M"], method=m)
            for m in ("acco", "dpu", "ddp")}
# Phase 9's remat paths: the long-context path with train.remat 'dots'
# (K5's O and LSE saved: its forward launched once a layer) and true (the
# whole layer recomputed: K5's forward twice a layer)
REMAT_PATHS = {
    f"llama3-8B-L8192-remat-{mode}": dict(
        MAIN_PATHS["llama3-8B-L8192"], extra=[f"train.remat={mode}"],
        per_microbatch={**MAIN_PATHS["llama3-8B-L8192"]["per_microbatch"],
                        "flash_fwd": LLAMA3_LAYERS * (2 if mode == "true" else 1)})
    for mode in ("dots", "true")
}
# the kernel each JSON entry reports launches for: its own slice's path
OWN_PATH = {**dict.fromkeys(_K1, "llama-125M"), **dict.fromkeys(_K2, "gptneo"),
            **dict.fromkeys(_K3, "llama-125M-fusedce"), **dict.fromkeys(_K5, "llama3-8B-L8192"),
            **dict.fromkeys(_K4, "llama3-8B-L8192-ring"), "blk_fwd_pos": "gptneo-ring"}
SOURCE = {**dict.fromkeys(_K1, "fused_attention.cu"), **dict.fromkeys(_K2, "banded_attention.cu"),
          **dict.fromkeys(_K3, "fused_ce.cu"), **dict.fromkeys(_K5, "flash_attention.cu"),
          **dict.fromkeys(_K4, "block_attention.cu")}


def ring_trainer(path: str, sg, extra=(), eager: bool = False):
    """The trainer of a ring path: its base path's configuration, the model
    on the ring, and ``sg`` (a one-rank sequence group) handed in."""
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.parallel.mesh import RankGroups

    return build_trainer([*main_args(RING_PATHS[path]["base"]), *extra],
                         groups=RankGroups.around(sg), eager=eager)


def dp_trainer(path: str, group, extra=(), eager: bool = False):
    """The trainer of a dp path: its configuration and ``group`` (a
    one-rank process group) handed in as the data-parallel group."""
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.parallel.mesh import RankGroups

    return build_trainer([*main_args(path), *extra], groups=RankGroups.around(data_group=group),
                         eager=eager)


def path_spec(path: str) -> dict:
    return (MAIN_PATHS.get(path) or RING_PATHS.get(path) or DP_PATHS.get(path)
            or TP_PATHS.get(path) or PP_PATHS.get(path) or COMPOSED_PATHS.get(path)
            or REMAT_PATHS[path])


def path_microbatches(path: str) -> int:
    """Microbatches of a path's run: n_acc a round (1 but on phase 14's
    GPT-Neo-2.7B cells), over the rounds and the seed round but under
    ddp."""
    spec = path_spec(path)
    return (MAIN_ROUNDS + (spec.get("method", "acco") != "ddp")) * spec.get("n_acc", 1)


def path_trainer(path: str, sg=None, group=None, extra=(), eager: bool = False):
    """The trainer of any path (``sg``: a ring path's sequence group;
    ``group``: a dp path's data group, a tp path's tensor group, a
    composed path's ``RankGroups.around`` pair; ``eager``: its rounds as
    eager calls, not the captured programs)."""
    from acco_tpu_torch.__main__ import build_trainer

    if path in COMPOSED_PATHS and "axes" in COMPOSED_PATHS[path]:
        return build_trainer([*main_args(COMPOSED_PATHS[path]["args_of"]), *extra],
                             groups=group, eager=eager)
    if path in RING_PATHS:
        return ring_trainer(path, sg, extra, eager)
    if path in DP_PATHS:
        return dp_trainer(path, group, extra, eager)
    if path in TP_PATHS:
        return tp_trainer(path, group, extra, eager)
    if path in PP_PATHS and "base" in PP_PATHS[path]:
        return pp_trainer(path, group, extra, eager)
    return build_trainer([*main_args(path), *extra], eager=eager)


def dense_order(trainer):
    """The permutation that reads the flat vectors of a model laid out by
    its model axes at size 1 (``TpLayout``, ``ComposedLayout``: the
    replicated segments first) in the dense model's order, with the
    padding after; None where the two orders agree (Llama's replicated
    leaves sort first anyway, GPT-Neo's do not)."""
    import torch

    model = trainer.model
    if model.tp_layout is None:
        return None
    if model.model_group.size != 1:
        raise ValueError("the dense order of a flat vector of one model index of several")
    local = {path: offset for path, _, offset in model.tp_layout.layout}
    if all(local[path] == offset for path, _, offset in model.dense_layout):
        return None
    device = trainer.device
    idx = [torch.arange(local[path], local[path] + math.prod(shape), device=device)
           for path, shape, _ in model.dense_layout]
    n = sum(t.numel() for t in idx)
    return torch.cat([*idx, torch.arange(n, trainer.step.geom.padded_size, device=device)])


def release_groups(trainer, sg=None, group=None) -> None:
    """Destroy the process groups ``build_trainer`` made around the groups
    handed in (``sg``, a SequenceGroup; ``group``, a process group): their
    comm twins. Each holds an NCCL communicator (~320 MiB of the card's
    memory outside the allocator on the H100, phase 15 found), and
    nothing else frees them before the script's end."""
    import torch.distributed as dist

    groups = getattr(trainer.mesh, "groups", None)
    if groups is None:
        return
    keep = {id(g) for g in (None if sg is None else sg.group, group, dist.group.WORLD)}
    made = {}
    for field in dataclasses.fields(groups):
        g = getattr(groups, field.name)
        if field.type == "object" and g is not None and id(g) not in keep:
            made[id(g)] = g
    for g in made.values():
        dist.destroy_process_group(g)


def state_fingerprint(state, order=None) -> list:
    """Per state leaf, two int64 sums over its bits (the bits as
    integers, plainly and weighted by a hash of the position), chunk by
    chunk on the card: equal fingerprints are equal states bar a
    collision, and a 27 GB state costs no copy. ``order``
    (:func:`dense_order`): the flat leaves (the parameters, the pending
    gradients and, at one shard, the optimizer's) read in that order."""
    import torch

    from acco_tpu_torch.compile.graphs import flatten

    out = []
    for leaf in flatten(state):
        if order is not None and leaf.dim() == 1 and leaf.numel() == order.numel():
            leaf = leaf.index_select(0, order)
        bits = leaf.detach().contiguous().reshape(-1).view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[leaf.element_size()])
        plain = mixed = 0
        for lo in range(0, bits.numel(), 1 << 26):
            c = bits[lo:lo + (1 << 26)].to(torch.int64)
            i = torch.arange(lo, lo + c.numel(), device=c.device, dtype=torch.int64)
            plain += int(c.sum())
            mixed += int((c * ((i * 2654435761) % 2147483647 + 1)).sum())
        out.append((plain, mixed))
    return out


def main_path(path: str, sg=None, group=None, eager: bool = False
              ) -> tuple[dict, float, int, dict]:
    """The port's entry point's trainer (``build_trainer``, then
    ``train()``), in-process, at the model's full width (a ring path: its
    trainer on the one-rank group ``sg``; a dp path: its trainer on the
    one-rank data group ``group``), its rounds captured and replayed
    (``eager``: as eager calls), with every launch count (and the
    materialized head's calls) set to 0 just before the run and read just
    after; returns the counts, the median round ms, the peak memory and
    the summary, to which it adds the final state's fingerprint
    (``fingerprint``, its flat leaves in the dense model's order), the
    peak reserved bytes and the allocator's retries."""
    import torch

    spec = path_spec(path)
    method = spec.get("method", "acco")
    model = path
    free_device_cache()  # the earlier paths' cached blocks: no fragments carried over
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    from acco_tpu_torch.analysis.donation import watch_round_programs

    with HeadLogitsCalls() as head, BlockWindows() as windows, \
            watch_round_programs() as watched:
        trainer = path_trainer(path, sg, group, eager=eager)
        reset_launch_counts()
        summary = trainer.train()
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    train_state_gates(path + ("-eager" if eager else ""), trainer, None if eager else watched)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    if path not in COMPOSED_PATHS:  # phase 15 destroys its groups itself
        release_groups(trainer, sg, group)
    summary.update(fingerprint=state_fingerprint(trainer.final_state, dense_order(trainer)),
                   peak_bytes=peak,
                   reserved_bytes=torch.cuda.max_memory_reserved(), retries=retries)
    del trainer
    want_as = "eager" if eager else "captured"
    if summary["rounds_as"] != want_as:
        raise AssertionError(f"{path}: rounds ran as {summary['rounds_as']}, not {want_as}")
    rounds = summary["round_log"]
    if len(rounds) != MAIN_ROUNDS or summary["method"] != method:
        raise AssertionError(f"expected {MAIN_ROUNDS} {method} rounds, ran {len(rounds)} "
                             f"{summary['method']}")
    losses = [summary["seed_loss"]] * (method != "ddp") + [r["loss"] for r in rounds]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    real = [r["is_real_update"] for r in rounds]
    if real != [r % 2 == 1 or method != "acco" for r in range(MAIN_ROUNDS)]:
        raise AssertionError(f"is_real_update of {method}: {real}")
    microbatches = path_microbatches(path)  # n_acc 1
    if summary["fused_loss"] != spec["fused_loss"]:
        raise AssertionError(f"{model}: fused_loss resolved to {summary['fused_loss']!r}")
    if summary["attention"] != spec["attention"]:
        raise AssertionError(f"{model}: attention resolved to {summary['attention']!r}")
    if head.count != spec["head_logits"] * microbatches:
        raise AssertionError(f"{model}: the materialized head ran {head.count} times, expected "
                             f"{spec['head_logits']} per microbatch x {microbatches}")
    want_windows = {w: n * microbatches for w, n in spec.get("pos_windows", {}).items()}
    if windows.counts != want_windows:
        raise AssertionError(f"{model}: K4's positional launches by window {windows.counts}, "
                             f"expected {want_windows}")
    for name, per_mb in spec["per_microbatch"].items():
        if launches[name] != per_mb * microbatches:
            raise AssertionError(
                f"{model}: {name} launched {launches[name]} times, expected {per_mb} "
                f"per microbatch x {microbatches} microbatches"
            )
    round_ms = [r["ms"] for r in rounds]
    med = statistics.median(round_ms)
    seq, d_model = spec["seq"], spec["d_model"]
    tokens = spec["batch"] * seq * spec.get("n_acc", 1)
    log(f"  attention {summary['attention']}  fused_loss {summary['fused_loss']}  "
        f"n_params {summary['n_params']}")
    log(f"  losses {['%.4f' % x for x in losses]}")
    log(f"  is_real_update {real}")
    log(f"  round ms {['%.1f' % x for x in round_ms]}  median {med:.2f}")
    tok_s = tokens / (med / 1e3)
    # model FLOPs per token: 6 N for the matmuls (the tied head counted
    # once; an untied embedding table, a lookup, not at all) plus, per
    # layer, 12 d times the mean keys a row attends (forward and backward
    # of QK^T and PV)
    n_matmul = summary["n_params"] - spec["embed_params"]
    mean_keys = [band_pairs(1, 1, seq, w) / seq for w in spec["windows"]]
    flops_per_token = 6 * n_matmul + sum(12 * d_model * m for m in mean_keys)
    log(f"  MFU formula: (6 x {n_matmul} + sum over layers of 12 x {d_model} x "
        f"mean keys {sorted(set(round(m, 3) for m in mean_keys))}) x tokens/s / "
        f"{PEAK_BF16_FLOPS:.3g}")
    log(f"  tokens/s {tok_s:.1f}  MFU {flops_per_token * tok_s / PEAK_BF16_FLOPS:.4f} "
        f"(vs {PEAK_BF16_FLOPS:.3g} FLOP/s bf16)")
    log(f"  max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB); max_memory_reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB; allocator retries {retries} (a "
        f"retry frees the cached blocks after a device-wide sync)")
    log(f"  launches {launches}  materialized head calls {head.count}"
        + (f"  K4 positional launches by window {windows.counts}" if windows.counts else ""))
    report = summary["compile_report"]
    if not eager:
        log(f"  rounds as {summary['rounds_as']}: train_warmup_join_ms "
            f"{report['warmup_join_ms']:.1f} (builds joined {report['join_ms'] or 0.0:.1f}); programs "
            f"{ {n: (round(r['warmup_ms'] or 0, 1), round(r['capture_ms'] or 0, 1)) for n, r in report['programs'].items()} } "
            f"(warm-up ms, capture ms); warm-up launches, not counted above: "
            f"{ {k: v for k, v in report['warmup_launches'].items() if v} }; constructor to "
            f"the first round read back {summary['init_to_first_round_s']:.2f} s")
    return launches, med, peak, summary


ATTENTION_RUNS = (
    ["train.use_pallas_attention=fused", "train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)
CE_RUNS = (
    ["train.use_pallas_attention=fused", "train.fused_loss=pallas"],
    ["train.use_pallas_attention=fused", "train.fused_loss=false"],
)
FLASH_RUNS = (
    ["train.use_pallas_attention=true", "train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)


RING_RUNS = (
    ["train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)


def small_input_agreement(args: list[str], kernels: tuple[str, ...], runs=ATTENTION_RUNS,
                          plain_silent: tuple[str, ...] | None = None, sg=None) -> None:
    """The entry point twice on a small float32 input (4 ACCO rounds),
    with the overrides of ``runs``: once through the kernels (on the ring,
    with ``sg`` handed in, when given) and once through their plain path.
    Every kernel in ``kernels`` launched in the first run; none of
    ``plain_silent`` (by default: no kernel at all) in the second; the
    losses and the last staged gradients agree."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.parallel.mesh import RankGroups

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for group, extra in zip((sg, None), runs):
        reset_launch_counts()
        trainer = build_trainer([
            *args, "train.nb_steps_tot=4", "train.use_mixed_precision=false", *extra,
            *run_flags(),
        ], groups=None if group is None else RankGroups.around(group))
        summary = trainer.train()
        release_groups(trainer, group)
        out.append((summary, trainer.final_state, launch_counts()))
    (s_k, st_k, n_k), (s_p, st_p, n_p) = out
    silent = n_p.keys() if plain_silent is None else plain_silent
    if any(n_k[k] == 0 for k in kernels) or any(n_p[k] for k in silent):
        raise AssertionError(f"kernel launches: kernel run {n_k}, plain run {n_p}")
    losses_k = [s_k["seed_loss"]] + [r["loss"] for r in s_k["round_log"]]
    losses_p = [s_p["seed_loss"]] + [r["loss"] for r in s_p["round_log"]]
    g_k, g_p = st_k.pending_grads, st_p.pending_grads
    err = float((g_k - g_p).abs().max())
    # float32 on both sides; only the summation order differs
    tol = 1e-4 * float(g_p.abs().max())
    log(f"  launches (kernel run) { {k: n_k[k] for k in kernels} }")
    log(f"  losses kernel {['%.6f' % x for x in losses_k]}")
    log(f"  losses plain  {['%.6f' % x for x in losses_p]}")
    log(f"  staged grads max abs diff {err:.3e} (tol {tol:.3e} = 1e-4 * max|g|)")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(losses_k, losses_p)) or err > tol:
        raise AssertionError("kernel and plain training runs disagree")


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on the card (any free local port),
    yielding its SequenceGroup (the port's context-parallel code with no
    hop) and destroyed on the way out."""
    import socket

    import torch
    import torch.distributed as dist

    from acco_tpu_torch.ops.ring_attention import SequenceGroup

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield SequenceGroup.of(dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# Phase 6's stream-ordering runs: tiny128 in float32 with the plain
# attention and CE (the kernels are not what they test), 6 ACCO rounds;
# the planted sleep spins the card ~10 ms (2e7 cycles at ~1.98 GHz). A
# planted fault's sleep must outlast the host's enqueueing of a round
# (~10-25 ms): it starts at ~0.4 s and grows 4x, twice at most, until
# the run's events show that the race it opens was taken.
STREAM_RUN = ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
              "train.batch_size=4", f"train.nb_steps_tot={MAIN_ROUNDS}",
              "train.use_mixed_precision=false", "train.use_pallas_attention=xla",
              "train.fused_loss=false"]
SLEEP_CYCLES = 20_000_000
FAULT_SLEEP_CYCLES = 40 * SLEEP_CYCLES
FAULT_TRIES = 3
BRANCHES = {"comm": "_comm_branch", "compute": "_compute_branch"}


def stream_rounds(on_current: bool, plant: str | None = None, drop: str | None = None,
                  cycles: int = SLEEP_CYCLES):
    """The seed round and 6 ACCO rounds of :data:`STREAM_RUN`'s trainer,
    driven back to back with no read on the host between them (the
    trainer's per-round read of the loss would order the rounds on the
    host): the comm branch on its own stream, or on the current stream
    when ``on_current``; ``plant`` ('comm' | 'compute') spins the card for
    ``cycles`` at the head of that branch, on its stream, every round.

    ``drop`` ('_fork' | '_join') removes that wait (a planted fault), and
    the sleep is then planted in round 0 only: round 0's ``plant`` branch
    writes what round 1's other branch reads, and without the wait the
    reader may run first. With ``_join`` removed the comm branch's fresh
    float buffers are filled with NaN on the current stream first, so
    that such a read cannot meet what an earlier identical run left there.

    Returns the losses and LRs, every leaf of the final state and, with
    ``drop``, the ms by which round 1's reader ended before round 0's
    writer (> 0: the race was taken), from events on the two streams."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
    from acco_tpu_torch.parallel.common import block_from_numpy

    trainer = build_trainer([*STREAM_RUN, *run_flags()])
    step = trainer.step
    compute = torch.cuda.current_stream()
    if on_current:
        step.comm_stream = compute
    ends = {"comm": [], "compute": []}  # with ``drop``: an event after each branch

    def poisoned(alloc):
        def out(numel: int, dtype):
            buf = alloc(numel, dtype)
            if buf.is_floating_point():
                with torch.cuda.stream(compute):
                    buf.fill_(float("nan"))
            return buf
        return out

    for branch, name in BRANCHES.items():
        original = getattr(step, name)

        def wrapped(*args, _original=original, _branch=branch):
            if _branch == plant and (drop is None or not ends[_branch]):
                torch.cuda._sleep(cycles)
            if drop == "_join" and _branch == "comm":
                args = (*args[:2], poisoned(args[2]))
            out = _original(*args)
            if drop is not None:
                ends[_branch].append(torch.cuda.Event(enable_timing=True))
                ends[_branch][-1].record()
            return out

        setattr(step, name, wrapped)
    if drop is not None:
        setattr(step, drop, lambda stream: None)
    batches = infinite_batches(trainer.loader)
    blocks = [block_from_numpy(stack_microbatches(batches, 1), trainer.device)
              for _ in range(MAIN_ROUNDS + 1)]
    gen = torch.Generator(device=trainer.device).manual_seed(trainer.seed)
    state = step.init_state(trainer.model.init_flat(gen))
    torch.cuda.synchronize()
    state, loss = step.seed(state, blocks[0])
    scalars = [loss]
    for r in range(MAIN_ROUNDS):
        state, m = step.round(state, blocks[r + 1], parity=r % 2 == 0)
        scalars += [m.loss, m.lr]
    torch.cuda.synchronize()
    lead = None
    if drop is not None:
        reader = "compute" if plant == "comm" else "comm"
        lead = ends[reader][1].elapsed_time(ends[plant][0])
    leaves = [state.flat_params, state.pending_grads, state.pending_count, *state.zero1.opt,
              state.zero1.sched_grads, state.zero1.grads_committed, *state.health]
    return [float(x) for x in scalars], [t.clone() for t in leaves], lead


def stream_ordering() -> None:
    """The comm stream changes no bit: the rounds through it equal the
    rounds with the comm branch on the current stream, plainly and with a
    sleep planted at the head of either branch. With a wait removed and a
    sleep on the side it guards long enough that the race it opens is
    taken (checked with an event, not left to the host's pace), they
    must differ."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    want_losses, want, _ = stream_rounds(on_current=True)

    def same(losses, leaves) -> bool:
        return losses == want_losses and all(torch.equal(a, b) for a, b in zip(leaves, want))

    for plant in (None, "comm", "compute"):
        ok = same(*stream_rounds(on_current=False, plant=plant)[:2])
        log(f"  comm stream, sleep planted at {plant or 'no'} branch head: "
            f"{'bit-identical' if ok else 'DIFFERS'} to the one-stream rounds")
        if not ok:
            raise AssertionError("the comm stream changed the rounds' results")
    for drop, plant in (("_join", "comm"), ("_fork", "compute")):
        cycles = FAULT_SLEEP_CYCLES
        for _ in range(FAULT_TRIES):
            losses, leaves, lead = stream_rounds(on_current=False, plant=plant, drop=drop,
                                                 cycles=cycles)
            if lead > 0:
                break
            log(f"  planted fault: {drop} removed, {cycles:.2e} cycles of sleep at round 0's "
                f"{plant} branch head: round 1's reader ended {-lead:.3f} ms after round 0's "
                f"writer, the race not taken; again with 4x")
            cycles *= 4
        else:
            raise AssertionError(f"a sleep of {cycles // 4:.2e} cycles did not open the race "
                                 f"that a removed {drop} allows")
        ok = same(losses, leaves)
        log(f"  planted fault: {drop} removed, {cycles:.2e} cycles of sleep at round 0's "
            f"{plant} branch head: round 1's reader ended {lead:.3f} ms before round 0's "
            f"writer, the race taken: "
            f"{'bit-identical (fault missed)' if ok else 'differs (fault caught)'}")
        if ok:
            raise AssertionError(f"the stream check missed a removed {drop}")
    log(f"  one-stream losses and LRs {['%.6g' % x for x in want_losses]}")


def dp_losses_vs(path: str, summary: dict, reference: dict) -> float:
    """A dp path's first loss against the Llama-125M path's on the same
    weights and batch: round 0 of acco and dpu (the first round computes
    at the initial weights on the second block), step 0 of ddp (the first
    block, the seed round's). A one-rank dp group runs the same
    arithmetic, so they should agree to the bit; the bar is the ring's."""
    method = DP_PATHS[path]["method"]
    got = summary["round_log"][0]["loss"]
    want = reference["seed_loss"] if method == "ddp" else reference["round_log"][0]["loss"]
    rel = abs(got - want) / abs(want)
    log(f"  first loss: {method} on the dp group {got:.6f}  llama-125M {want:.6f}  relative "
        f"difference {rel:.3e} (bar {RING_LOSS_RTOL:g})")
    if rel > RING_LOSS_RTOL:
        raise AssertionError(f"{path}'s first loss is off the llama-125M path's")
    return rel


# the ring paths against the paths they share weights and data with:
# losses in bf16 within this share of the reference (both sides round
# the attention output to bf16; K4 merges float32 partials where K5 and
# K1/K2 normalise in-kernel), gradients within this relative L2 distance
RING_LOSS_RTOL = 1e-3
RING_GRAD_RTOL = 1e-2


def ring_loss_vs(summary: dict, reference: dict, what: str) -> float:
    """The round-0 loss of a ring path against its reference path's: same
    weights (the seed), same batch (the loader's seed), both before any
    update (round 0 computes at the initial weights)."""
    got, want = summary["round_log"][0]["loss"], reference["round_log"][0]["loss"]
    rel = abs(got - want) / abs(want)
    log(f"  round-0 loss: ring {got:.6f}  {what} {want:.6f}  relative difference {rel:.3e} "
        f"(bar {RING_LOSS_RTOL:g})")
    if rel > RING_LOSS_RTOL:
        raise AssertionError(f"the ring path's round-0 loss is off the {what} path's")
    return rel


def neo_ring_step_agreement(sg) -> None:
    """GPT-Neo-125M, one forward and backward on the same weights and
    batch: the windowed ring (K4, on the one-rank group) against the
    non-CP path (K1 on the global layers, K2 on the local ones), both
    with the loss through K3."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
    from acco_tpu_torch.parallel.common import block_from_numpy, prep_cp_leaves
    from acco_tpu_torch.parallel.mesh import RankGroups

    out = []
    for group in (sg, None):
        trainer = build_trainer([*main_args("gptneo"), "train.fused_loss=pallas"],
                                groups=None if group is None else RankGroups.around(group))
        device = trainer.device
        flat = trainer.step.init_state(trainer.model.init_flat(
            torch.Generator(device=device).manual_seed(trainer.seed))).flat_params
        block = block_from_numpy(stack_microbatches(infinite_batches(trainer.loader), 1), device)
        block = prep_cp_leaves(block, group, trainer.model.zigzag)
        reset_launch_counts()
        loss, grads = trainer.step.value_and_grad(flat, {
            "input_ids": block.input_ids[0], "attention_mask": block.attention_mask[0],
            "labels": block.labels[0]})
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        out.append((float(loss), torch.cat([g.float().reshape(-1) for g in grads]),
                    launch_counts()))
        release_groups(trainer, group)
        del trainer, flat, grads
        free_device_cache()
    (loss_r, g_r, n_r), (loss_d, g_d, n_d) = out
    rel = abs(loss_r - loss_d) / abs(loss_d)
    g_rel = float((g_r - g_d).norm() / g_d.norm())
    log(f"  launches: ring { {k: n_r[k] for k in _K4 + _K1[:1] + _K2[:1]} }")
    log(f"  launches: non-CP { {k: n_d[k] for k in _K4 + _K1[:1] + _K2[:1]} }")
    log(f"  loss ring {loss_r:.6f}  non-CP {loss_d:.6f}  relative difference {rel:.3e} (bar "
        f"{RING_LOSS_RTOL:g}); gradients |ring - non-CP| / |non-CP| = {g_rel:.3e} (bar "
        f"{RING_GRAD_RTOL:g})")
    if (n_r["blk_fwd_pos"] != LAYERS or n_r["attn_fwd"] or n_d["blk_fwd_pos"]
            or not n_d["attn_fwd"] or not n_d["banded_fwd"]):
        raise AssertionError("the two GPT-Neo runs did not take the kernels they name")
    if rel > RING_LOSS_RTOL or g_rel > RING_GRAD_RTOL:
        raise AssertionError("GPT-Neo's windowed ring and its non-CP path disagree")


def profile_main_path(model: str, round_ms: float, top: int = 12, sg=None, group=None,
                      eager: bool = False) -> dict:
    """Where the device time of a main path goes: the same run again with
    ``train.profile_steps`` over its steady rounds (after the first two of
    ACCO, the first of DPU and DDP; a captured run's captures come before
    them), the trace read by the package's reader
    (``acco_tpu_torch/telemetry/profile.py``, which names a replay's
    streams by the graphs' probes). Prints device ms per microbatch (n_acc
    1: per round) for the top kernels and by kernel family, the device's
    idle share of a round (1 - the union of every stream's activity / the
    measured run's median round ms; the kernel sum beside it, which counts
    overlapped time twice), the comm side's device ms and its overlap
    share, the part under compute-stream activity, and the host's launch
    calls, graph launches and the kernels a round. An ACCO or DPU path
    must show device work off the compute stream (its comm branch)."""
    from acco_tpu_torch.telemetry.profile import load_events

    free_device_cache()
    skip = 2 if path_spec(model).get("method", "acco") == "acco" else 1
    rounds = MAIN_ROUNDS - skip
    trainer = path_trainer(model, sg, group, extra=[f"train.profile_steps={rounds}"],
                           eager=eager)
    method = trainer.method
    summary = trainer.train()
    release_groups(trainer, sg, group)
    del trainer
    st = summary["profile"]
    if st.get("device") != "cuda" or st["rounds"] != rounds:
        raise AssertionError(f"{model}: the profile holds no device activity: {st}")
    PROFILE_TRACES[model, eager] = st["trace"]
    events = load_events(st["trace"])
    kernels: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            row = kernels.setdefault(e["name"], [0.0, 0])
            row[0] += float(e.get("dur", 0)) / 1e3 / rounds
            row[1] += 1
    per_mb = sum(ms for ms, _ in kernels.values())
    union_mb = st["union_ms"]
    share = st["comm_under_compute_ms"] / st["comm_ms"] if st["comm_ms"] else 0.0
    log(f"  {model} ({'eager' if eager else 'captured'}): device busy {union_mb:.2f} ms per "
        f"microbatch (union of streams over {rounds} steady rounds; kernel sum {per_mb:.2f}; "
        f"profiled wall {st['wall_ms']:.2f} ms a round); idle share of a {round_ms:.2f} ms round "
        f"{1 - union_mb / round_ms:.3f} (by the kernel sum {1 - per_mb / round_ms:.3f}; of the "
        f"profiled wall {st['idle_share']:.3f})")
    log(f"  streams: compute {st['compute_ms']:.3f} ms/microbatch; comm side (comm stream, "
        f"NCCL) {st['comm_ms']:.3f} ms/microbatch, {st['comm_under_compute_ms']:.3f} under "
        f"compute-stream activity: overlap share {share:.3f}; copy side {st['copy_ms']:.3f} "
        f"ms/microbatch; busy ms by role:stream "
        f"{ {k: round(v, 3) for k, v in st['streams_ms'].items()} }"
        + (f"; graph streams {st['graph_streams']}" if "graph_streams" in st else ""))
    log(f"  the host a round: {st['kernel_launch_calls']:.1f} kernel launch calls, "
        f"{st['graph_launches']:.1f} graph launches; the device ran {st['kernels']:.1f} kernels")
    if method != "ddp" and st["comm_ms"] <= 0:
        raise AssertionError(f"{model}: no device work off the compute stream (the comm branch)")
    if not eager and st["graph_launches"] < 1:
        raise AssertionError(f"{model}: no graph launch in a captured run's rounds")
    for family in ("K1", "K2", "K3", "K5", "K4"):
        names = [k for k in kernels if kernel_family(k) == family]
        ms = sum(kernels[k][0] for k in names)
        log(f"  {family} kernels: {ms:.3f} ms/microbatch "
            f"({', '.join(sorted({kernel_label(k) for k in names}))})")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {ms:9.3f} ms/microbatch x{n // rounds:<4d} {kernel_label(name)}: {name[:90]}")
    return {"union_ms_per_microbatch": union_mb, "kernel_sum_ms_per_microbatch": per_mb,
            "comm_ms_per_microbatch": st["comm_ms"], "overlap_share": share,
            "copy_ms_per_microbatch": st["copy_ms"], "idle_share": 1 - union_mb / round_ms,
            "kernels": st["kernels"], "kernel_launch_calls": st["kernel_launch_calls"],
            "graph_launches": st["graph_launches"]}


def stream_variant_ms(model: str, sg=None, group=None) -> float:
    """The median round ms of a path's rerun with its comm branch on the
    current stream (``comm_stream`` None: the branches one after the
    other), beside phase 5's run on two streams."""
    import torch

    free_device_cache()
    trainer = path_trainer(model, sg, group)
    trainer.step.comm_stream = None
    summary = trainer.train()
    torch.cuda.synchronize()
    release_groups(trainer, sg, group)
    return statistics.median(r["ms"] for r in summary["round_log"])


# A profiled kernel's family, by its name: K5, K2 and K4 before K1, since
# the attention mainloop's instances (hopper_attention.cuh) are
# attn_*_kernel for all four and differ in their mask policy.
KERNEL_FAMILIES = (("K5", r"\bflash_|SegmentMask"), ("K2", r"\bbanded_|BandMask"),
                   ("K4", r"\bblk_|BlockMask"), ("K1", r"\battn_|WindowPadMask"),
                   ("K3", r"\bce_(fwd|bwd)"))


def kernel_family(key: str):
    return next((family for family, tag in KERNEL_FAMILIES if re.search(tag, key)), None)


def kernel_label(key: str) -> str:
    """A kernel's short name in a profile: the epilogue of a Hopper GEMM
    (``hopper_gemm_kernel<..., ce_fwd_epilogue>``), else its own name, with
    the mask policy of an attention mainloop instance."""
    m = re.search(r"\w+_epilogue", key) or re.search(r"\w+_kernel", key) or re.search(r"\w+", key)
    label = m.group(0) if m else key
    policy = re.search(r"SegmentMask|WindowPadMask|BandMask|BlockMask<\d+>", key)
    return f"{label}<{policy.group(0)}>" if policy else label


# Phase 8: a run that stops and goes on, at Llama-125M's full width (12
# layers, d 768, seq 1024, batch 8, bf16, K1): ACCO with 2 DPU warmup
# rounds, the eval every 4 grads, a constant LR (a cosine's shape depends
# on nb_steps_tot, which sets runs A and B apart). A goes uninterrupted to
# RESUME_N2 grads; B stops at RESUME_N1 (the warmup's 2 grads and two ACCO
# commits: mid-epoch, on a commit, its pending grads in flight) with its
# final save; C resumes from B's checkpoint root to RESUME_N2 and must end
# bit-equal to A. Bars of the eval and the perplexity, bf16, kernel path
# against the plain attention and the materialized CE on the same params:
# relative 2e-3 (the per-token differences of bf16 rounding, averaged
# over ~65k tokens, sit far below it; a wrong kernel moves the mean by
# far more)
RESUME_N1, RESUME_N2, RESUME_EVAL_STEP, RESUME_CADENCE = 6, 10, 4, 2
EVAL_RTOL = PPL_RTOL = 2e-3
PPL_SAMPLES, PPL_LEN = 64, 256
# (d) the logging cadence: 20 rounds read back every 10 grads; the mean
# round ms between the boundaries at 10 and 20 grads (rounds 11-20, the
# host free to run ahead of the card in between). Both cells' runs are
# held bit-equal (phase 9 (a), phase 11 (c)); Llama-125M's alone profiled
# (the fused-CE cell's profiles cut for time since PR 18)
CADENCE, CADENCE_ROUNDS = 10, 20
CADENCE_PATHS = ("llama-125M", "llama-125M-fusedce")
PROFILED_CADENCE = "llama-125M"


def resume_args(run_dir: str, nb: int, *extra: str) -> list[str]:
    return [*main_args("llama-125M", RESUME_CADENCE), "train.n_warmup_steps=2", "train.eval=true",
            f"train.eval_step={RESUME_EVAL_STEP}", "train.scheduler_name=constant",
            f"train.nb_steps_tot={nb}", f"hydra.run.dir={run_dir}", *extra]


def resume_run(run_dir: str, nb: int, *extra: str):
    import torch

    from acco_tpu_torch.__main__ import build_trainer

    trainer = build_trainer(resume_args(run_dir, nb, *extra))
    summary = trainer.train()
    torch.cuda.synchronize()
    return trainer, summary


@contextlib.contextmanager
def resume_fault(fault: str):
    """A fault planted in the resume: 'loader' drops the restored loader
    position, 'pending' zeroes the restored pending grads."""
    import torch

    from acco_tpu_torch.data.loader import ShardedBatchIterator
    from acco_tpu_torch.utils import checkpoint as ckpt

    if fault == "loader":
        owner, name = ShardedBatchIterator, "set_state"
        patched = lambda self, state: None  # noqa: E731
    else:
        owner, name = ckpt, "restore_checkpoint"
        original = ckpt.restore_checkpoint

        def patched(*args, **kwargs):
            state, meta = original(*args, **kwargs)
            return state._replace(pending_grads=torch.zeros_like(state.pending_grads)), meta
    saved = getattr(owner, name)
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def state_leaves(state, prefix: str = "") -> dict:
    out = {}
    for name, value in zip(state._fields, state):
        if isinstance(value, tuple):
            out.update(state_leaves(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = value
    return out


def resumed_differences(resumed, summary: dict, reference, ref_summary: dict) -> list:
    """What of a resumed run differs from the uninterrupted one: state
    leaves (bit for bit), round losses, eval losses at the same counts."""
    import torch

    got, want = state_leaves(resumed.final_state), state_leaves(reference.final_state)
    diffs = [k for k in want if not torch.equal(got[k], want[k])]
    rounds = summary["round_log"]
    if [r["loss"] for r in rounds] != [r["loss"] for r in ref_summary["round_log"][-len(rounds):]]:
        diffs.append("round losses")
    ref_evals = {e["count_grad_tot"]: e["eval_loss"] for e in ref_summary["eval_log"]}
    if any(ref_evals.get(e["count_grad_tot"]) != e["eval_loss"] for e in summary["eval_log"]):
        diffs.append("eval losses")
    return diffs


def cadence_ms(path: str, *extra: str, eager: bool = False) -> tuple[float, dict, object]:
    """(d) A main path's ``CADENCE_ROUNDS`` rounds through the entry point's
    trainer at ``delta_step_for_log=CADENCE``: the mean round ms between
    its two boundaries (the rows' dispatch ms, the boundary round's with
    the wait for the read back), the summary and the final flat params
    (``eager``: the rounds as eager calls)."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer

    free_device_cache()
    trainer = build_trainer([*main_args(path, CADENCE), f"train.nb_steps_tot={CADENCE_ROUNDS}",
                             *extra], eager=eager)
    summary = trainer.train()
    rounds = summary["round_log"]
    if len(rounds) != CADENCE_ROUNDS or summary["count_grad_tot"] != CADENCE_ROUNDS:
        raise AssertionError(f"{path}: {len(rounds)} rounds to {summary['count_grad_tot']} "
                             f"grads, expected {CADENCE_ROUNDS}")
    losses = [r["loss"] for r in rounds]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"{path}: non-finite loss at cadence {CADENCE}: {losses}")
    return (statistics.fmean(r["ms"] for r in rounds[CADENCE:]), summary,
            trainer.final_state.flat_params)


def resume_phase(smi: str, round_ms: dict) -> tuple[dict, dict]:
    """(a) exact resume with two planted faults and a torn newer step (the
    prefetch on, at depth 2), (b) the eval through K1 and K3's forward
    alone, (c) perplexity on B's params.npz through K1, (d) the cadence's
    mean round ms beside phase 5's synced median (``round_ms``); returns
    the eval's launches and (d)'s runs (mean ms, summary, final flat
    params) by path."""
    import torch

    from acco_tpu_torch import perplexity_eval as ppl
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.utils import checkpoint as ckpt

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        log(f" (a) exact resume: {' '.join(resume_args('<run dir>', RESUME_N2))}")
        a, sa = resume_run(f"{tmp}/a", RESUME_N2)
        if not (sa["prefetch"] and a.prefetch_depth == 2):
            raise AssertionError("phase 8 runs with the prefetch on at depth 2")
        log(f"  A: {RESUME_N2} grads uninterrupted; seed {sa['seed_loss']:.6f}, warmup "
            f"{['%.6f' % x for x in sa['warmup_losses']]}, rounds "
            f"{['%.6f' % r['loss'] for r in sa['round_log']]}, evals "
            f"{[(e['count_grad_tot'], round(e['eval_loss'], 6)) for e in sa['eval_log']]}")
        b, sb = resume_run(f"{tmp}/b", RESUME_N1, "train.save=true")
        step = sb["checkpoint"]
        with open(os.path.join(step, "meta.json")) as f:
            meta = json.load(f)
        pos = meta["loader"]
        if not (pos["epoch"] == 0 and 0 < pos["batch_pos"] < len(b.loader)):
            raise AssertionError(f"B's save is not mid-epoch: {pos}, {len(b.loader)} a epoch")
        if sb["round_log"][-1]["is_real_update"] is not True:
            raise AssertionError("B did not stop on an ACCO commit")
        n_bytes = sum(os.path.getsize(os.path.join(d, n))
                      for d, _, names in os.walk(step) for n in names)
        save_ms = b.save_ms[-1]
        log(f"  B: stopped at {RESUME_N1} grads, saved {step} at loader {pos} "
            f"({len(b.loader)} batches an epoch): {n_bytes} bytes in {save_ms:.1f} ms")
        torn = os.path.join(b.ckpt_dir, f"step_{RESUME_N1 + 1}")
        shutil.copytree(step, torn)
        rank0 = os.path.join(torn, "state", "rank_0.pt")
        with open(rank0, "r+b") as f:
            f.truncate(os.path.getsize(rank0) // 2)
        if ckpt.latest_checkpoint(b.ckpt_dir) != step:
            raise AssertionError("latest_checkpoint did not skip the truncated newer step")
        log(f"  a truncated rank_0.pt in a newer {os.path.basename(torn)}: latest_checkpoint "
            f"falls back to {os.path.basename(step)}")
        del b
        resume = f"train.resume_from={os.path.dirname(step)}"
        c, sc = resume_run(f"{tmp}/c", RESUME_N2, resume)
        restore_ms = c.restore_ms
        diffs = resumed_differences(c, sc, a, sa)
        log(f"  C: resumed in {restore_ms:.1f} ms (torch.load of the rank file, leaves to the "
            f"card), {len(sc['round_log'])} rounds, evals "
            f"{[(e['count_grad_tot'], round(e['eval_loss'], 6)) for e in sc['eval_log']]}: "
            f"{'bit-equal to A' if not diffs else 'DIFFERS from A in ' + str(diffs)}")
        if diffs:
            raise AssertionError(f"the resumed run differs from the uninterrupted one: {diffs}")
        del c
        for fault in ("loader", "pending"):
            with resume_fault(fault):
                d, sd = resume_run(f"{tmp}/{fault}", RESUME_N2, resume)
            diffs = resumed_differences(d, sd, a, sa)
            del d
            what = ("the loader position dropped" if fault == "loader"
                    else "pending_grads zeroed")
            log(f"  planted fault, {what}: "
                f"{'differs (caught) in ' + str(diffs) if diffs else 'bit-equal (MISSED)'}")
            if not diffs:
                raise AssertionError(f"the resume check missed the planted fault {fault!r}")
        flat = a.final_state.flat_params
        del a
        free_device_cache()

        log(" (b) the eval on A's final params: K1 and K3's forward (fused_loss=pallas) "
            "against the plain attention and the materialized CE")
        kern = build_trainer([*main_args("llama-125M-fusedce"), "train.eval=true",
                              f"hydra.run.dir={tmp}/k"])
        plain = build_trainer([*main_args("llama-125M"), "train.use_pallas_attention=xla",
                               "train.fused_loss=false", "train.eval=true",
                               f"hydra.run.dir={tmp}/p"])
        n_batches = len(kern.eval_rows) // kern.batch_size
        with HeadLogitsCalls() as head:
            reset_launch_counts()
            loss_k = kern.evaluate(flat)
            torch.cuda.synchronize()
            counts = launch_counts()
        want = {**dict.fromkeys(_K2 + _K5 + _K4, 0), "attn_fwd": LAYERS * n_batches,
                **dict.fromkeys(_K1[1:], 0), "ce_fwd": n_batches, **dict.fromkeys(_K3[1:], 0),
                "vp_ce": 0}
        log(f"  {n_batches} eval batches of {kern.batch_size} x {kern.max_length}: launches "
            f"{ {k: v for k, v in counts.items() if v} }, materialized head calls {head.count}")
        if counts != want or head.count:
            raise AssertionError(f"the eval's launches {counts} (head {head.count}), expected "
                                 f"{want}")
        reset_launch_counts()
        loss_p = plain.evaluate(flat)
        torch.cuda.synchronize()
        if any(launch_counts().values()):
            raise AssertionError(f"the plain eval launched kernels: {launch_counts()}")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        log(f"  eval loss: kernels {loss_k:.6f}  plain {loss_p:.6f}  relative difference "
            f"{rel:.3e} (bar {EVAL_RTOL:g})")
        if rel > EVAL_RTOL:
            raise AssertionError("the kernels' eval loss is off the plain one")
        t0 = time.perf_counter()
        kern.evaluate(flat)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3 / n_batches
        del kern, plain, flat
        free_device_cache()

        log(f" (c) perplexity of B's params.npz, {PPL_SAMPLES} samples of <= {PPL_LEN} "
            "tokens: K1 against the plain attention")
        device = torch.device("cuda", 0)
        model_k, model_cfg = ppl.build("llama-125M", device=device)
        model_p, _ = ppl.build("llama-125M", device=device, attention="xla")
        params = torch.from_numpy(ckpt.load_flat_params(step, model_k.n_params))
        texts = load_text_dataset({"path": "synthetic"}, test_size=0.01)[0][:PPL_SAMPLES]
        tok = load_tokenizer(model_cfg.get("tokenizer"))
        reset_launch_counts()
        t0 = time.perf_counter()
        ppl_k = ppl.compute(model_k, params, tok, texts, max_length=PPL_LEN)
        torch.cuda.synchronize()
        ppl_ms = (time.perf_counter() - t0) * 1e3
        ppl_launches = launch_counts()["attn_fwd"]
        ppl_p = ppl.compute(model_p, params, tok, texts, max_length=PPL_LEN)
        want_ppl = ppl_p["mean_perplexity"]
        rel_ppl = abs(ppl_k["mean_perplexity"] - want_ppl) / want_ppl
        log(f"  mean perplexity: K1 {ppl_k['mean_perplexity']:.6f} ({ppl_launches} attn_fwd "
            f"launches, {ppl_ms:.1f} ms)  plain {ppl_p['mean_perplexity']:.6f}  relative "
            f"difference {rel_ppl:.3e} (bar {PPL_RTOL:g})")
        if ppl_launches != LAYERS * -(-PPL_SAMPLES // 8) or rel_ppl > PPL_RTOL:
            raise AssertionError("the perplexity through K1 is off the plain one, or K1 did not "
                                 "run")
        log(f"  phase 8 on {smi}: checkpoint {n_bytes} bytes, save {save_ms:.1f} ms, restore "
            f"{restore_ms:.1f} ms, eval {eval_ms:.2f} ms a batch of 8 x 1024 (K1 + K3 forward), "
            f"perplexity {ppl_k['mean_perplexity']:.4f}")

        log(f" (d) the logging cadence: {CADENCE_ROUNDS} rounds read back every {CADENCE} "
            f"grads, the mean round ms of rounds {CADENCE + 1}-{CADENCE_ROUNDS}")
        cadence = {}
        for path in CADENCE_PATHS:
            cadence[path] = cadence_ms(path)
            log(f"  {path} on {smi}: mean round ms at delta_step_for_log={CADENCE} "
                f"{cadence[path][0]:.3f}; phase 5's synced median (delta_step_for_log=1) "
                f"{round_ms[path]:.3f}")
        return counts, cadence
    finally:
        shutil.rmtree(tmp, True)


# Phase 9: the input pipeline off the round, remat, finetuning from a
# local HF checkpoint. (a) Llama-125M for 20 rounds at
# delta_step_for_log=10 with the prefetch off, against phase 8 (d)'s runs
# with it on (the default): bit-equal losses and final params, the mean
# round ms of rounds 11-20, the idle share from a profiled rerun and the
# consumer's wait for its block; then the copy's planted fault. (c) the
# long-context path under remat 'dots' and true, and tiny128 in float32
# through K1 under each mode against remat off. (d) GPT-Neo-125M and
# Llama-125M written as HF checkpoint directories and finetuned
# (train=acco-ft), their perplexity, and GPT-Neo-2.7B's preset scored
# through K1 + K2. (e) the native collate ran on every path.
PREFETCH_FAULT_ROWS = 64
FT_NB = 8  # grads: a seed round and 4 ACCO rounds of n_acc 2 at batch 4 x 512
FT_FAMILIES = {"gptneo": "gpt-neo-125M.json", "llama-125M": "llama-125M.json"}
NEO_LARGE_SCORE = dict(B=2, L=2048)
REMAT_F32 = ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4", "train.use_mixed_precision=false", "train.fused_loss=false"]


def profile_cadence(path: str, mean_ms: float, *extra: str) -> float:
    """The idle share of a path at ``delta_step_for_log=CADENCE``: its run
    again with ``train.profile_steps`` over its rounds after the first two
    (the captures and the warm-ups come before them), 1 - the union of
    every stream's activity per microbatch / ``mean_ms`` (the unprofiled
    run's mean round ms)."""
    from acco_tpu_torch.__main__ import build_trainer

    free_device_cache()
    rounds = CADENCE_ROUNDS - 2
    trainer = build_trainer([*main_args(path, CADENCE), f"train.nb_steps_tot={CADENCE_ROUNDS}",
                             f"train.profile_steps={rounds}", *extra])
    prof = trainer.train()["profile"]
    del trainer
    if prof.get("device") != "cuda" or prof["rounds"] != rounds:
        raise AssertionError(f"{path}: the cadence profile holds no device activity: {prof}")
    return 1 - prof["union_ms"] / mean_ms


def prefetch_fault_run(wait: bool, cycles: int, seed: int):
    """One block through the prefetch worker and a copy stream that sleeps
    ``cycles`` before its copies: read (cloned) on the current stream as
    soon as the consumer has it, with the copy's event waited on
    (``wait``) or not (the planted fault). Returns whether the read equals
    the host block and the ms by which the read ended before the copy
    (> 0: the race was taken)."""
    import numpy as np
    import torch

    from acco_tpu_torch.data.loader import ShardedBatchIterator
    from acco_tpu_torch.data.prefetch import PinnedBlockCopy, PrefetchingBlockSource
    from acco_tpu_torch.native import FlatTokenDataset

    device = torch.device("cuda", 0)
    rows = np.random.default_rng(seed).integers(0, VOCAB, (PREFETCH_FAULT_ROWS, SEQ))

    def loader():
        return ShardedBatchIterator(FlatTokenDataset.from_packed(rows.astype(np.int32)), BATCH,
                                    SEQ, pad_token_id=0, seed=seed)

    class SleepyCopy(PinnedBlockCopy):
        def put(self, host):
            if self.stream is None:
                torch.cuda.set_device(self.device)
                self.stream = torch.cuda.Stream(device=self.device)
            with torch.cuda.stream(self.stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                torch.cuda._sleep(cycles)
            out, ready = super().put(host)
            with torch.cuda.stream(self.stream):
                copied = torch.cuda.Event(enable_timing=True)
                copied.record()
            return out, ready, start, copied

    copy = SleepyCopy(device)
    marks = {}

    def take(item):
        out, ready, marks["start"], marks["copied"] = item
        return copy.take((out, ready)) if wait else out

    want = PrefetchingBlockSource(loader(), 1, dict, prefetch=False).next_block()
    source = PrefetchingBlockSource(loader(), 1, copy.put, depth=2, take_block=take)
    try:
        got = [t.clone() for t in source.next_block()]
        read = torch.cuda.Event(enable_timing=True)
        read.record()
        torch.cuda.synchronize()
    finally:
        source.close()
    same = all(np.array_equal(g.cpu().numpy(), want[k].astype(g.cpu().numpy().dtype))
               for g, k in zip(got, ("input_ids", "attention_mask", "labels", "valid")))
    lead = marks["start"].elapsed_time(marks["copied"]) - marks["start"].elapsed_time(read)
    return same, lead


def prefetch_fault() -> None:
    """The copy's ordering: with the event waited on, a read of a block
    whose copy sleeps ~0.4 s first sees the host's values; with the wait
    removed the read must run before the copy (the events show the race
    taken, the sleep growing 4x if not) and see other values. Each run has
    its own data, so stale memory of an earlier one cannot match."""
    same, lead = prefetch_fault_run(True, FAULT_SLEEP_CYCLES, seed=91)
    log(f"  the consumer waits on the copy's event: read {-lead:.3f} ms after the sleeping "
        f"copy ended: {'equal to the host block' if same else 'DIFFERS from the host block'}")
    if not same or lead > 0:
        raise AssertionError("a block read after the copy's event differs from the host block")
    cycles = FAULT_SLEEP_CYCLES
    for attempt in range(FAULT_TRIES):
        same, lead = prefetch_fault_run(False, cycles, seed=92 + attempt)
        if lead > 0:
            break
        log(f"  planted fault, the wait removed: the read ended {-lead:.3f} ms after the copy, "
            f"the race not taken; again with 4x")
        cycles *= 4
    else:
        raise AssertionError("the copy's sleep did not open the race a removed wait allows")
    log(f"  planted fault, the wait removed, {cycles:.2e} cycles of sleep on the copy stream: "
        f"the read ended {lead:.3f} ms before the copy: "
        f"{'equal (fault MISSED)' if same else 'differs (fault caught)'}")
    if same:
        raise AssertionError("the prefetch check missed a removed wait on the copy's event")


def remat_agreement() -> None:
    """tiny128, float32, one microbatch through K1 (and the plain path for
    'dots+probs'): the loss and gradients of each remat mode against remat
    off, and K1's forward launches (True reruns it, the selective modes
    save its O and LSE)."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
    from acco_tpu_torch.parallel.common import block_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    for attention, modes in (("fused", ("true", "dots", "dots+probs")), ("xla", ("dots+probs",))):
        out = {}
        for mode in ("false", *modes):
            trainer = build_trainer([*REMAT_F32, f"train.use_pallas_attention={attention}",
                                     f"train.remat={mode}", *run_flags()])
            flat = trainer.model.init_flat(torch.Generator(device=trainer.device).manual_seed(7))
            block = block_from_numpy(stack_microbatches(infinite_batches(trainer.loader), 1),
                                     trainer.device)
            reset_launch_counts()
            loss, grads = trainer.step.value_and_grad(flat, {
                "input_ids": block.input_ids[0], "attention_mask": block.attention_mask[0],
                "labels": block.labels[0]})
            torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
            out[mode] = (loss, torch.cat([g.reshape(-1) for g in grads]),
                         launch_counts()["attn_fwd"])
        loss0, g0, n0 = out["false"]
        for mode in modes:
            loss, g, n = out[mode]
            bits = bool(torch.equal(loss, loss0) and torch.equal(g, g0))
            rel = float((g - g0).abs().max() / g0.abs().max())
            grads = "bit-equal" if bits else f"max diff {rel:.3e} of max|g|"
            log(f"  tiny128 float32 {attention}, remat {mode}: loss {float(loss):.8f} (off "
                f"{float(loss0):.8f}), gradients {grads}; attn_fwd launches {n} (off {n0})")
            want_n = 2 * n0 if (mode == "true" and attention == "fused") else n0
            if n != want_n or (not bits and (abs(float(loss - loss0)) > 1e-6 * abs(float(loss0))
                                              or rel > 1e-5)):
                raise AssertionError(f"remat {mode} on tiny128 ({attention}) is off remat off")


def remat_microbatch_peak(mode: str) -> tuple[int, tuple]:
    """The long-context path's trainer under ``train.remat=mode``: one
    microbatch's forward and backward at the initial weights, and its
    peak allocation above what was live before it (the activations, the
    gradients, K3's buffers). Returns that and (the loss, the live bytes)."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
    from acco_tpu_torch.parallel.common import block_from_numpy

    free_device_cache()
    trainer = build_trainer([*main_args("llama3-8B-L8192"), f"train.remat={mode}"])
    device = trainer.device
    flat = trainer.model.init_flat(torch.Generator(device=device).manual_seed(trainer.seed))
    block = block_from_numpy(stack_microbatches(infinite_batches(trainer.loader), 1), device)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = trainer.step.value_and_grad(flat, {
        "input_ids": block.input_ids[0], "attention_mask": block.attention_mask[0],
        "labels": block.labels[0]})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    loss = float(loss)
    del trainer, flat, block, grads
    free_device_cache()
    return peak, (loss, live)


def write_hf_checkpoint(path: str, config, flat) -> None:
    """The model's bf16 parameters as an HF checkpoint directory, in HF's
    names: ``config.json`` and ``model.safetensors`` (written here, without
    the safetensors package: an 8-byte little-endian header length, the
    JSON header, the raw bytes), the tied head omitted."""
    import numpy as np
    import torch

    from acco_tpu_torch.models.convert import params_to_jax
    from acco_tpu_torch.models.llama import LlamaConfig

    tree = params_to_jax(flat, config)
    lay, N = tree["layers"], config.num_layers
    tensors = {}
    if isinstance(config, LlamaConfig):
        hf = {"model_type": "llama", "vocab_size": config.vocab_size,
              "hidden_size": config.hidden_size, "intermediate_size": config.intermediate_size,
              "num_hidden_layers": N, "num_attention_heads": config.num_heads,
              "num_key_value_heads": config.num_kv_heads,
              "max_position_embeddings": config.max_position_embeddings,
              "rope_theta": config.rope_theta, "rms_norm_eps": config.rms_norm_eps,
              "tie_word_embeddings": config.tie_word_embeddings,
              "bos_token_id": config.bos_token_id, "eos_token_id": config.eos_token_id}
        tensors["model.embed_tokens.weight"] = tree["wte"]
        tensors["model.norm.weight"] = tree["final_norm"]
        for i in range(N):
            pre = f"model.layers.{i}."
            tensors[pre + "input_layernorm.weight"] = lay["attn_norm"][i]
            tensors[pre + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
            for ours, theirs in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                                 ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                                 ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                                 ("w_down", "mlp.down_proj")):
                tensors[pre + theirs + ".weight"] = lay[ours][i].T
        if not config.tie_word_embeddings:
            tensors["lm_head.weight"] = tree["lm_head"].T
    else:
        hf = {"model_type": "gpt_neo", "vocab_size": config.vocab_size,
              "hidden_size": config.hidden_size, "num_layers": N, "num_heads": config.num_heads,
              "max_position_embeddings": config.max_position_embeddings,
              "window_size": config.window_size,
              "attention_layers": list(config.attention_layers),
              "attention_types": [[list(config.attention_layers), 1]],
              "intermediate_size": config.intermediate_size,
              "activation_function": config.activation_function,
              "layer_norm_epsilon": config.layer_norm_epsilon, "tie_word_embeddings": True,
              "bos_token_id": config.bos_token_id, "eos_token_id": config.eos_token_id}
        tensors["transformer.wte.weight"] = tree["wte"]
        tensors["transformer.wpe.weight"] = tree["wpe"]
        tensors["transformer.ln_f.weight"] = tree["lnf_scale"]
        tensors["transformer.ln_f.bias"] = tree["lnf_bias"]
        for i in range(N):
            pre = f"transformer.h.{i}."
            att = pre + "attn.attention."
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                tensors[att + proj + ".weight"] = lay["w_qkv"][i][:, j, :].T
            tensors[att + "out_proj.weight"] = lay["wo"][i].T
            tensors[att + "out_proj.bias"] = lay["wo_bias"][i]
            for ours, theirs in (("ln1_scale", "ln_1.weight"), ("ln1_bias", "ln_1.bias"),
                                 ("ln2_scale", "ln_2.weight"), ("ln2_bias", "ln_2.bias"),
                                 ("b_fc", "mlp.c_fc.bias"), ("b_proj", "mlp.c_proj.bias")):
                tensors[pre + theirs] = lay[ours][i]
            tensors[pre + "mlp.c_fc.weight"] = lay["w_fc"][i].T
            tensors[pre + "mlp.c_proj.weight"] = lay["w_proj"][i].T
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name, arr in tensors.items():
        blob = (torch.from_numpy(np.ascontiguousarray(arr)).bfloat16().view(torch.uint8)  # lint: host-sync-ok: a CPU tensor's bytes for the file
                .numpy().tobytes())
        header[name] = {"dtype": "BF16", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


class PadMaskedK1:
    """Counts K1's forward launches that carry a pad mask while the
    context is open (a launch table of ``compile.graphs.counting``: a
    replay adds what its capture counted)."""

    @property
    def count(self) -> int:
        return self.calls["masked"]

    def __enter__(self):
        from acco_tpu_torch.compile.graphs import counting
        from acco_tpu_torch.ops import fused_attention as fa

        self.module, self.original, self.calls = fa, fa.attn_fwd, {"masked": 0}
        self.counting = counting(self.calls)
        self.counting.__enter__()

        def counted(q, k, v, pad_mask, window, scale):
            self.calls["masked"] += pad_mask is not None
            return self.original(q, k, v, pad_mask, window, scale)

        fa.attn_fwd = counted
        return self

    def __exit__(self, *exc):
        self.module.attn_fwd = self.original
        self.counting.__exit__(*exc)


def finetune_run(model: str, ckpt: str, tmp: str, *extra: str):
    import torch

    from acco_tpu_torch.__main__ import build_trainer

    free_device_cache()
    trainer = build_trainer(["train=acco-ft", f"model={model}", f"model.config_path={ckpt}",
                             "data=synthetic", f"train.nb_steps_tot={FT_NB}",
                             "train.eval_step=4", "+train.delta_step_for_log=2",
                             "train.save=false", f"hydra.run.dir={tmp}/run", *extra])
    return trainer


def finetune_phase(tmp: str) -> dict:
    """(d) Each model at full width, random init from the seed, written as
    an HF checkpoint directory and finetuned through the entry point's
    trainer (``train=acco-ft``: truncated rows with pad masks, max_length
    512, batch 4, n_acc 2, the eval on): the loaded flat vector bit-equal
    to the one written, K1's launches with a pad mask counted, the first
    loss equal to the same model's built from those params by
    ``params_from_jax``; the perplexity eval on the directory through the
    kernels against the plain attention; GPT-Neo-2.7B's preset (D 128)
    scored through K1 + K2 against the plain path. Returns the finetune
    runs' and the scoring's launches."""
    import torch

    from acco_tpu_torch import perplexity_eval as ppl
    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.models.convert import params_from_jax, params_to_jax
    from acco_tpu_torch.models.hf_loader import from_pretrained
    from acco_tpu_torch.models.registry import build_model, model_config

    device = torch.device("cuda", 0)
    launches = {}
    for model, arch in FT_FAMILIES.items():
        _, config = model_config(f"/config/model/{arch}", REPO)
        base = build_model({"config_path": f"/config/model/{arch}"}, REPO, device=device)
        flat = base.init_flat(torch.Generator(device=device).manual_seed(17))
        ckpt = os.path.join(tmp, f"hf-{model}")
        t0 = time.perf_counter()
        write_hf_checkpoint(ckpt, config, flat)
        write_ms = (time.perf_counter() - t0) * 1e3
        del base
        trainer = finetune_run(model, ckpt, tmp)
        loaded = trainer.initial_params
        if not torch.equal(loaded.to(device), flat.float()):
            raise AssertionError(f"{model}: the loaded flat vector differs from the one written")
        with PadMaskedK1() as masked:
            reset_launch_counts()
            summary = trainer.train()
            torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
            counts = launch_counts()
        rounds = summary["round_log"]
        mbs = 2 * (1 + len(rounds))
        losses = [summary["seed_loss"]] + [r["loss"] for r in rounds]
        layers = config.num_layers
        log(f"  {model}: {os.path.getsize(os.path.join(ckpt, 'model.safetensors'))} bytes "
            f"written in {write_ms:.1f} ms, loaded bit-equal; {mbs} microbatches of 4 x 512 "
            f"with pad masks, losses {['%.4f' % x for x in losses]}, evals "
            f"{[(e['count_grad_tot'], round(e['eval_loss'], 4)) for e in summary['eval_log']]}; "
            f"launches { {k: v for k, v in counts.items() if v} }, K1 forwards with a pad mask "
            f"{masked.count}")
        if (summary["count_grad_tot"] != FT_NB or not summary["eval_log"]
                or not all(map(lambda x: x == x and abs(x) != float("inf"), losses))
                or counts["attn_bwd_dq"] != layers * mbs or counts["banded_fwd"]
                or masked.count != counts["attn_fwd"] or masked.count < layers * mbs):
            raise AssertionError(f"{model}: the finetune run is off: {summary['count_grad_tot']} "
                                 f"grads, launches {counts}, masked {masked.count}")
        launches[f"{model}-finetune"] = counts
        ref = finetune_run(model, f"/config/model/{arch}", f"{tmp}/ref",
                           "train.finetune=false", "train.nb_steps_tot=2")
        ref.initial_params = params_from_jax(params_to_jax(flat, config), config)
        seed = ref.train()["seed_loss"]
        log(f"  {model}: first loss {summary['seed_loss']!r}; the same model from the "
            f"architecture file with params_from_jax of the written params {seed!r}")
        if seed != summary["seed_loss"]:
            raise AssertionError("the finetune run's first loss is off the same model's "
                                 "built from its params")
        del ref
        if model == "gptneo":
            texts = load_text_dataset({"path": "synthetic"}, test_size=0.01)[0][:16]
            tok = load_tokenizer(ckpt)
            log(f"  the checkpoint's tokenizer: {type(tok).__name__}, 'a b' -> "
                f"{tok('a b')['input_ids']}")
            reset_launch_counts()
            got = ppl.main(["--hf-checkpoint", ckpt, "--n-samples", "16", "--max-length", "256"])
            n_k1 = launch_counts()["attn_fwd"]
            plain, pflat = from_pretrained(ckpt, device=device, attention="xla")
            want = ppl.compute(plain, pflat, tok, texts, max_length=256)
            rel = abs(got["mean_perplexity"] - want["mean_perplexity"]) / want["mean_perplexity"]
            log(f"  perplexity_eval --hf-checkpoint: {got['mean_perplexity']:.6f} through K1 "
                f"({n_k1} attn_fwd launches), plain {want['mean_perplexity']:.6f}, relative "
                f"difference {rel:.3e} (bar {PPL_RTOL:g})")
            if rel > PPL_RTOL or n_k1 != layers * 2 or not want["mean_perplexity"] > 1.0:
                raise AssertionError("the perplexity eval of the checkpoint is off the plain one")
            del plain, pflat
        del trainer, loaded, flat
        free_device_cache()

    log(f" GPT-Neo-2.7B's preset (config_path EleutherAI/gpt-neo-2.7B, D 128), random init, bf16, "
        f"forward only at {NEO_LARGE_SCORE}: K1 + K2 against the plain path")
    spec = {"config_path": "EleutherAI/gpt-neo-2.7B"}
    kern = build_model(spec, REPO, device=device, attention="fused")
    flat = kern.init_flat(torch.Generator(device=device).manual_seed(19))
    kern.load_flat(flat)
    ids = torch.randint(0, VOCAB, (NEO_LARGE_SCORE["B"], NEO_LARGE_SCORE["L"]),
                        generator=torch.Generator(device=device).manual_seed(20), device=device)
    losses = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for name in ("kernels", "plain"):
            model = kern if name == "kernels" else build_model(spec, REPO, device=device,
                                                               attention="xla")
            model.load_flat(flat)
            reset_launch_counts()
            t0 = time.perf_counter()
            logits = model.apply(ids)
            losses[name] = float(torch.nn.functional.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1)))
            torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in launch_counts().items() if v}
            log(f"  {name}: loss {losses[name]:.6f} in {ms:.1f} ms, launches {counts}, "
                f"{kern.n_params} params, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if name == "kernels":
                launches["gpt-neo-2.7B-score"] = launch_counts()
                if counts != {"attn_fwd": 16, "banded_fwd": 16}:
                    raise AssertionError(f"GPT-Neo-2.7B did not run K1 + K2 a layer each: {counts}")
            del logits
    rel = abs(losses["kernels"] - losses["plain"]) / losses["plain"]
    log(f"  relative difference {rel:.3e} (bar {PPL_RTOL:g})")
    if rel > PPL_RTOL:
        raise AssertionError("GPT-Neo-2.7B through K1 + K2 is off the plain path")
    del kern, model, flat
    free_device_cache()
    return launches


def phase_9(smi: str, cadence: dict, round_ms: dict, peaks: dict) -> dict:
    """Phase 9; returns its paths' launches."""
    import torch

    from acco_tpu_torch import native

    launches = {}
    native.reset_call_counts()
    log(f" (a) the prefetch: {CADENCE_ROUNDS} rounds at delta_step_for_log={CADENCE}, prefetch "
        f"on (phase 8 (d)'s runs) and off; {PROFILED_CADENCE}'s profiled")
    for path in CADENCE_PATHS:
        # on (phase 8 (d)), then off (the turns off, on, off cut for time)
        runs = {"on": [cadence[path]], "off": []}
        for setting in ("off",):
            runs[setting].append(cadence_ms(path, f"train.prefetch={setting == 'on'}"))
        _, s_ref, flat_ref = runs["on"][0]
        for setting, (_, s, flat) in [(k, r) for k in runs for r in runs[k]]:
            same = ([r["loss"] for r in s["round_log"]] == [r["loss"] for r in s_ref["round_log"]]
                    and s["seed_loss"] == s_ref["seed_loss"] and torch.equal(flat, flat_ref))
            if not same or s["prefetch"] != (setting == "on"):
                raise AssertionError(f"{path}: a run with the prefetch {setting} differs from "
                                     "the first prefetched one")
        mean = {k: [r[0] for r in runs[k]] for k in runs}
        wait = {k: [r[1]["block_wait_ms"] for r in runs[k]] for k in runs}
        idle = dict.fromkeys(runs, "not profiled")
        if path == PROFILED_CADENCE:
            for k, extra in (("on", ()), ("off", ("train.prefetch=false",))):
                idle[k] = f"{profile_cadence(path, statistics.fmean(mean[k]), *extra):.3f}"
        for k in ("on", "off"):
            log(f"  {path} on {smi}, prefetch {k}: mean round ms (rounds {CADENCE + 1}-"
                f"{CADENCE_ROUNDS}) {['%.3f' % m for m in mean[k]]}, mean "
                f"{statistics.fmean(mean[k]):.3f}; median block wait "
                f"{['%.3f' % w for w in wait[k]]} ms; idle share (profiled rerun) {idle[k]}")
        log(f"  {path}: losses and final params of the runs bit-equal; phase 5's synced "
            f"median (prefetch on) {round_ms[path]:.3f}")
        del runs, flat_ref
    cadence.clear()
    free_device_cache()
    log(" the copy stream's event: a planted fault")
    prefetch_fault()
    log(" (b) resume with the prefetch on at depth 2: phase 8 (a) (above)")

    log(" (c) remat: the long-context path under train.remat dots and true (off: phase 5)")
    base = "llama3-8B-L8192"
    log(f"  remat off (phase 5): peak {peaks[base] / 2**30:.2f} GiB, median round "
        f"{round_ms[base]:.2f} ms, flash_fwd {LLAMA3_LAYERS} a microbatch")
    log("  one microbatch's forward and backward (value_and_grad) at the initial weights: "
        "its allocation above what was live before it")
    for mode in ("false", "dots", "true"):
        peak, loss = remat_microbatch_peak(mode)
        log(f"  remat {mode} on {smi}: {peak / 2**30:.2f} GiB above the live "
            f"{loss[1] / 2**30:.2f} GiB, loss {loss[0]!r}")
    for path in REMAT_PATHS:
        log(f"  {path}: {' '.join(main_args(path))}")
        launches[path], med, peak, _ = main_path(path)
        log(f"  {path} on {smi}: peak allocated {peak / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB, median round {med:.2f} ms, "
            f"flash_fwd {launches[path]['flash_fwd'] // path_microbatches(path)} a microbatch")
        free_device_cache()
    remat_agreement()

    log(" (d) finetuning from a local HF checkpoint")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        launches.update(finetune_phase(tmp))
    finally:
        shutil.rmtree(tmp, True)

    log(" (e) the native collate")
    calls = dict(native.CALLS)
    built = (f"g++ built it in this process in {native.BUILD_INFO['seconds']:.2f} s"
             if native.BUILD_INFO else "an earlier build of the same source")
    log(f"  available: {native.native_available()} ({native._so_path()}: {built}); calls in "
        f"this phase {calls}")
    if not native.native_available() or not calls["collate_batch"] or not calls["pack_const_len"]:
        raise AssertionError("the paths did not run the native collate")
    return launches


# Phase 10: a run that survives. Llama-125M at full width (ACCO unless
# named), 20 rounds read back every 10 grads (the default cadence) unless
# named; each run's launches counted (K1 on every one).
P10_PATH = "llama-125M"
P10_ROUNDS = 20
P10_META_VOLATILE = ("saved_at_unix", "elapsed_s", "id_run")


# the drills phase 10 (c) runs captured and phase 11 (d) again eager: their
# overrides and grads
DRILLS = {
    "nan_grads@3": (["+train.delta_step_for_log=2", "train.fault_injection=nan_grads@3"], 8),
    "rollback": (["+train.delta_step_for_log=4", "train.rollback_after_skipped=2",
                  "train.save=true", "train.checkpoint_every_s=0", "train.ckpt_keep_last=0",
                  "train.fault_injection=[{kind: corrupt_params, round: 5, n: 64}]"], 12),
}


def p10_args(run: str, nb: int = P10_ROUNDS, *extra: str) -> list[str]:
    return [*main_args(P10_PATH, CADENCE), f"train.nb_steps_tot={nb}",
            f"hydra.run.dir={run_root()}/p10/{run}", *extra]


def p10_run(run: str, launches: dict, *extra: str, nb: int = P10_ROUNDS, setup=None,
            during=None):
    """A phase-10 run through the entry point's trainer (``setup(trainer)``
    before ``train()``; ``during(trainer)`` a context around it), its
    launches counted under ``p10-<run>``; returns the trainer and summary."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer

    free_device_cache()
    trainer = build_trainer(p10_args(run, nb, *extra))
    if setup is not None:
        setup(trainer)
    reset_launch_counts()
    with (during(trainer) if during is not None else contextlib.nullcontext()):
        summary = trainer.train()
    torch.cuda.synchronize()
    launches[f"p10-{run}"] = launch_counts()
    if launches[f"p10-{run}"]["attn_fwd"] <= 0:
        raise AssertionError(f"phase 10 {run}: K1 was not launched")
    losses = [r["loss"] for r in summary["round_log"]]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses[-1:])):
        raise AssertionError(f"phase 10 {run}: non-finite final loss {losses[-1:]}")
    return trainer, summary


def p10_mean(summary: dict) -> float:
    return statistics.fmean(r["ms"] for r in summary["round_log"][CADENCE:])


def rank_file(step: str) -> dict:
    import torch

    return torch.load(os.path.join(step, "state", "rank_0.pt"), map_location="cpu",
                      weights_only=True)


def checkpoint_differences(a: str, b: str) -> list:
    """The leaves (and meta keys, timestamps and run ids apart) in which
    two step dirs differ."""
    import torch

    sa, sb = rank_file(a)["state"], rank_file(b)["state"]
    diffs = [k for k in sb if k not in sa or not torch.equal(sa[k], sb[k])]
    metas = []
    for step in (a, b):
        with open(os.path.join(step, "meta.json")) as f:
            meta = json.load(f)
        metas.append({k: v for k, v in meta.items() if k not in P10_META_VOLATILE})
    if metas[0] != metas[1]:
        diffs.append("meta " + str({k for k in metas[0].keys() | metas[1].keys()
                                    if metas[0].get(k) != metas[1].get(k)}))
    return diffs


def final_state_differences(a, b) -> list:
    import torch

    got, want = state_leaves(a.final_state), state_leaves(b.final_state)
    return [k for k in want if not torch.equal(got[k], want[k])]


class RacingSnapshot:
    """A planted fault in the overlapped save: the copy stream sleeps
    ``cycles`` before the device-to-host copies (enqueued once the host
    buffers exist, so the first save's allocation does not use up the
    sleep), and the loop does not wait on the snapshot's event, so the
    next rounds reuse (and write) the memory being copied. The commit
    still waits for the copies."""

    def __init__(self, cycles: int) -> None:
        self.cycles = cycles

    def __call__(self, trainer) -> None:
        import torch

        manager = trainer.ckpt_manager
        manager.copy_stream = torch.cuda.Stream()
        take = manager.buffers.take

        def take_then_sleep(leaves):
            host = take(leaves)
            with torch.cuda.stream(manager.copy_stream):
                torch.cuda._sleep(self.cycles)
            return host

        manager.buffers.take = take_then_sleep
        manager._wait_snapshot = lambda snap: None


@contextlib.contextmanager
def sigterm_after_rounds(n: int):
    """A timer thread that sends this process SIGTERM once the trainer's
    ``train_rounds_total`` counter has grown by ``n``."""
    import signal
    import threading

    from acco_tpu_torch.telemetry import metrics

    start = metrics.REGISTRY.value("train_rounds_total")
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            if metrics.REGISTRY.value("train_rounds_total") - start >= n:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.001)

    thread = threading.Thread(target=watch, name="p10-sigterm", daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


@contextlib.contextmanager
def runtime_sync_counts(out: dict):
    """``out``: the count of synchronizing CUDA runtime calls in the
    profiled block, by name, from the trace's ``cuda_runtime`` events
    (``cudaMemcpy`` is the blocking copy; ``cudaMemcpyAsync`` is not)."""
    from torch.profiler import ProfilerActivity, profile

    from acco_tpu_torch.telemetry.profile import load_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = load_events(path)
    for name in SYNC_CALLS:
        out[name] = sum(1 for e in events
                        if e.get("cat") == "cuda_runtime" and e.get("name") == name)


def phase_10(smi: str, profiles: dict, drills: dict) -> dict:
    """A run that survives (Llama-125M, full width): (a) the overlapped
    save against the synchronous one and no save, their checkpoints and a
    resume from the async one, and the racing snapshot (a planted fault);
    (b) SIGTERM from a timer thread, then resume; (c) the drills:
    nan_grads for acco, dpu, ddp, corrupt_params with its rollback held to
    a resume with the loader at the fence, and the fence dropped (a
    planted fault); (d) telemetry on and off under torch.profiler: the
    synchronizing runtime calls a round, the trace and the attribution;
    (e) profile_steps=4 on Llama-125M and llama3-8B-L8192 beside phase 7.
    Returns the launches by run; ``drills`` gets the summaries of the
    ACCO ``nan_grads@3`` and the rollback drills, with their final
    states' fingerprints (phase 11 (d)'s captured runs)."""
    import torch

    from acco_tpu_torch.data.loader import ShardedBatchIterator
    from acco_tpu_torch.telemetry.trace import validate_trace
    from acco_tpu_torch.utils import checkpoint as ckpt

    launches: dict = {}
    save = ["train.save=true", "train.checkpoint_every_s=0", "train.ckpt_keep_last=0"]
    log(f" (a) the overlapped save: {' '.join(p10_args('<run>'))} {' '.join(save)}")
    plain, s_plain = p10_run("nosave", launches)
    runs = {}
    for mode in ("true", "false"):
        t, s = p10_run(f"save-{mode}", launches, *save, f"train.ckpt_async={mode}")
        snaps = t.ckpt_manager.snapshot_log
        runs[mode] = (t, s)
        log(f"  ckpt_async={mode}: loop stall a save {[round(x, 1) for x in t.save_ms]} ms "
            f"(snapshot {[round(x['ms'], 1) for x in snaps]} ms, of it pinned-buffer "
            f"allocation {[round(x['alloc_ms'], 1) for x in snaps]} ms, {snaps[0]['bytes']} "
            f"bytes), commit {[round(x, 1) for x in t.ckpt_manager.commit_log]} ms; mean round "
            f"of rounds {CADENCE + 1}-{P10_ROUNDS} {p10_mean(s):.3f} ms (no save: "
            f"{p10_mean(s_plain):.3f})")
        if final_state_differences(t, plain):
            raise AssertionError(f"ckpt_async={mode}: saving changed the run's state")
    (ta, sa), (ts, ss) = runs["true"], runs["false"]
    steps = {os.path.basename(p) for p in ckpt.checkpoint_candidates(ta.ckpt_dir)}
    for step in sorted(steps):
        diffs = checkpoint_differences(os.path.join(ta.ckpt_dir, step),
                                       os.path.join(ts.ckpt_dir, step))
        log(f"  {step}: async against sync checkpoint: "
            f"{'tensor-equal, meta equal' if not diffs else 'DIFFERS in ' + str(diffs)}")
        if diffs:
            raise AssertionError(f"async and sync checkpoints of {step} differ: {diffs}")
    first = os.path.join(ta.ckpt_dir, f"step_{CADENCE}")
    r, sr = p10_run("resume-async", launches, f"train.resume_from={first}")
    diffs = final_state_differences(r, plain)
    log(f"  resumed from the async {os.path.basename(first)}: "
        f"{'bit-equal to the uninterrupted run' if not diffs else 'DIFFERS in ' + str(diffs)}")
    if diffs or [x["loss"] for x in sr["round_log"]] != [
            x["loss"] for x in s_plain["round_log"][CADENCE:]]:
        raise AssertionError(f"the run resumed from the async checkpoint differs: {diffs}")
    # at the two boundary saves (the final one adds params.npz), net of the
    # first save's one-time pinned allocation: the loop's wait for the
    # snapshot (async) against the whole save (sync)
    snaps_a, snaps_s = ta.ckpt_manager.snapshot_log, ts.ckpt_manager.snapshot_log
    stall_async = statistics.fmean(x["ms"] - x["alloc_ms"] for x in snaps_a[:2])
    stall_sync = statistics.fmean(ms - x["alloc_ms"] for ms, x in zip(ts.save_ms[:2], snaps_s))
    alloc_ms = snaps_a[0]["alloc_ms"]
    del r, ta
    cycles = FAULT_SLEEP_CYCLES
    for attempt in range(FAULT_TRIES):
        f, _ = p10_run(f"racing-{attempt}", launches, *save, "train.ckpt_async=true",
                       setup=RacingSnapshot(cycles))
        diffs = checkpoint_differences(os.path.join(f.ckpt_dir, f"step_{CADENCE}"),
                                       os.path.join(ts.ckpt_dir, f"step_{CADENCE}"))
        del f
        log(f"  planted fault, the loop not waiting on the snapshot (copy stream asleep "
            f"{cycles} cycles): {'caught, the saved tensors differ in ' + str(diffs) if diffs else 'NOT caught'}")
        if diffs:
            break
        cycles *= 4
    else:
        raise AssertionError("the racing snapshot was not caught")
    del ts, runs

    log(" (b) SIGTERM from a timer thread after 5 rounds")
    t, st = p10_run("sigterm", launches, "train.save=true",
                    during=lambda trainer: sigterm_after_rounds(5))
    if not st["interrupted"] or st["count_grad_tot"] >= P10_ROUNDS:
        raise AssertionError(f"SIGTERM did not interrupt the run: {st['interrupted']}, "
                             f"{st['count_grad_tot']} grads")
    if ckpt.validate_checkpoint(st["checkpoint"]) is not None:
        raise AssertionError(f"the interrupted run's checkpoint is not committed")
    with open(os.path.join(st["checkpoint"], "meta.json")) as fh:
        meta = json.load(fh)
    r, sr = p10_run("sigterm-resume", launches, f"train.resume_from={t.ckpt_dir}")
    diffs = final_state_differences(r, plain)
    log(f"  interrupted at round boundary {meta['rounds_done']} ({st['count_grad_tot']} grads, "
        f"{os.path.basename(st['checkpoint'])} committed); resumed to {sr['count_grad_tot']}: "
        f"{'bit-equal to the uninterrupted run' if not diffs else 'DIFFERS in ' + str(diffs)}")
    if diffs:
        raise AssertionError(f"the run resumed after SIGTERM differs: {diffs}")
    del t, r, plain  # no trainer of this phase stays alive into (e)'s long cell

    log(" (c) drills")
    for method in ("acco", "dpu", "ddp"):
        t, s = p10_run(f"nan-{method}", launches, f"train={method}",
                       *DRILLS["nan_grads@3"][0], nb=DRILLS["nan_grads@3"][1])
        if method == "acco":
            drills["nan_grads@3"] = dict(s, fingerprint=state_fingerprint(t.final_state))
        del t
        log(f"  nan_grads@3, {method}: skipped {s['skipped_rounds']}, {s['count_grad_tot']} "
            f"grads, final loss {s['final_loss']:.6f}")
        if not (s["skipped_rounds"] == 1 and s["count_grad_tot"] >= 8
                and math.isfinite(s["final_loss"])):
            raise AssertionError(f"nan_grads@3 on {method}: {s['skipped_rounds']} skipped, "
                                 f"{s['count_grad_tot']} grads, loss {s['final_loss']}")
    drill = ["+train.delta_step_for_log=4", "train.rollback_after_skipped=2"]
    rb, srb = p10_run("rollback", launches, *DRILLS["rollback"][0], nb=DRILLS["rollback"][1])
    drills["rollback"] = dict(srb, fingerprint=state_fingerprint(rb.final_state))
    if srb["rollbacks"] != 1 or srb["count_grad_tot"] < 12:
        raise AssertionError(f"corrupt_params: {srb['rollbacks']} rollbacks, "
                             f"{srb['count_grad_tot']} grads")
    event = rb.rollback_log[0]
    fence = event["fence"]
    original = ShardedBatchIterator.set_state
    results = {}
    for label, patched in (("fence", lambda self, state: original(self, fence)),
                           ("no fence", original)):
        ShardedBatchIterator.set_state = patched
        try:
            o, _ = p10_run(f"rollback-oracle-{label.replace(' ', '')}", launches, *drill,
                           f"train.resume_from={event['path']}", nb=12)
        finally:
            ShardedBatchIterator.set_state = original
        results[label] = final_state_differences(o, rb)
        del o
    log(f"  corrupt_params@5: rolled back once to {os.path.basename(event['path'])} "
        f"({event['count_grad_tot']} grads), fence {fence}; against a resume from it with the "
        f"loader at the fence: {'bit-equal' if not results['fence'] else 'DIFFERS in ' + str(results['fence'])}; "
        f"planted fault, the fence dropped: "
        f"{'caught, differs in ' + str(results['no fence']) if results['no fence'] else 'NOT caught'}")
    if results["fence"] or not results["no fence"]:
        raise AssertionError(f"rollback oracle: {results}")
    del rb

    log(" (d) telemetry on and off under torch.profiler: synchronizing runtime calls")
    tel = {}
    for enabled in ("true", "false"):
        counts: dict = {}
        s = p10_run(f"telemetry-{enabled}", launches, f"train.telemetry.enabled={enabled}",
                    during=lambda trainer, c=counts: runtime_sync_counts(c))[1]
        tel[enabled] = (counts, p10_mean(s), s)
        log(f"  telemetry.enabled={enabled}: sync calls {counts} "
            f"({sum(counts.values()) / P10_ROUNDS:.2f} a round); mean round of rounds "
            f"{CADENCE + 1}-{P10_ROUNDS} {p10_mean(s):.3f} ms (profiled)")
    if tel["true"][0] != tel["false"][0]:
        raise AssertionError(f"telemetry changes the sync calls: {tel['true'][0]} against "
                             f"{tel['false'][0]}")
    means = {"true": [], "false": []}
    # unprofiled, off then on (the turns off, on, on, off cut for time)
    for i, enabled in enumerate(("false", "true")):
        s = p10_run(f"telemetry-{enabled}-unprofiled-{i}", launches,
                    f"train.telemetry.enabled={enabled}")[1]
        means[enabled].append(p10_mean(s))
    log(f"  unprofiled, in turns off, on, on, off: mean round of rounds {CADENCE + 1}-"
        f"{P10_ROUNDS} off {[round(x, 3) for x in means['false']]} ms, on "
        f"{[round(x, 3) for x in means['true']]} ms")
    means = {k: statistics.fmean(v) for k, v in means.items()}
    on = tel["true"][2]
    with open(on["trace"]) as fh:
        problems = validate_trace(json.load(fh))
    report = on["attribution"]
    gap = abs(report["bucket_sum_ms"] - report["round_wall_ms"]) / report["round_wall_ms"]
    log(f"  trace {os.path.basename(on['trace'])}: validate_trace "
        f"{'passes' if not problems else problems[:3]}; attribution {report['buckets_ms']} sums "
        f"to {report['bucket_sum_ms']} of the {report['round_wall_ms']} ms round wall "
        f"({100 * gap:.2f}% apart)")
    if problems or gap > 0.05 or tel["false"][2]["trace"] is not None:
        raise AssertionError(f"telemetry: trace problems {problems[:3]}, bucket gap {gap}")

    log(" (e) profile_steps=4 (rounds 3-6 of ACCO under torch.profiler, in the program)")
    for path in ("llama-125M", "llama3-8B-L8192"):
        free_device_cache()
        from acco_tpu_torch.__main__ import build_trainer

        trainer = build_trainer([*main_args(path), "train.profile_steps=4"])
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        reset_launch_counts()
        summary = trainer.train()
        torch.cuda.synchronize()  # lint: host-sync-ok: the device drained before the clock reads
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
        launches[f"p10-profile-{path}"] = launch_counts()
        prof = summary["profile"]
        del trainer
        phase7 = profiles.get(path, {}).get("overlap_share")
        log(f"  {path}: profile {json.dumps({k: v for k, v in prof.items() if k != 'trace'})}; "
            f"rounds ms {[round(r['ms'], 1) for r in summary['round_log']]}, allocator retries "
            f"{retries}; phase 7's overlap share {phase7}")
        if not (prof.get("device") == "cuda" and prof["rounds"] == 4 and prof["comm_ms"] > 0
                and prof["copy_ms"] > 0 and 0 <= prof["measured_overlap_pct"] <= 100):
            raise AssertionError(f"{path}: profile_steps summary {prof}")
    log(f"  phase 10 on {smi}: the loop's wait a boundary save async {stall_async:.1f} ms "
        f"(the snapshot), sync {stall_sync:.1f} ms; the first save's pinned allocation "
        f"{alloc_ms:.1f} ms; rounds {CADENCE + 1}-{P10_ROUNDS} no save "
        f"{p10_mean(s_plain):.3f}, async {p10_mean(sa):.3f}, sync {p10_mean(ss):.3f} ms; "
        f"telemetry off {means['false']:.3f}, on {means['true']:.3f} ms")
    return launches


# Phase 11: the cells whose captured rounds must equal their eager rounds
# bit for bit (Llama-125M under acco, dpu and ddp, its fused-CE cell and
# GPT-Neo-125M); the other cells' equality is printed and held as named.
BIT_EQUAL_PATHS = ("llama-125M", "gptneo", "llama-125M-fusedce", "llama-125M-dp-acco",
                   "llama-125M-dp-dpu", "llama-125M-dp-ddp")
GRAPH_FAULT_PATH = "llama-125M"
LONG_PATHS = ("llama3-8B-L8192", "llama3-8B-L8192-ring")
ONE_STREAM_PATHS = ("llama-125M",)
# the cells profiled: phase 7 (captured) every main and ring cell (the dp
# cells are the Llama-125M cell's model and data), phase 11 (eager) the
# flagship and the long cell (the other cells' eager profiles cut for time)
PROFILED_PATHS = (*MAIN_PATHS, *RING_PATHS)
EAGER_PROFILED_PATHS = ("llama-125M", "llama3-8B-L8192")
PEAK_RISE = 0.05  # captured peak allocated within 5% of eager's


def same_values(a: list, b: list) -> bool:
    """Equal lists, a NaN equal to a NaN (a drill's skipped round logs one)."""
    return len(a) == len(b) and all(x == y or (x != x and y != y) for x, y in zip(a, b))


def captured_vs_eager(path: str, cap: dict, eager: dict) -> list:
    """What differs between a path's captured and eager runs: the seed
    and round losses, LRs and flags, the final state's fingerprint."""
    diffs = []
    if not same_values([cap["seed_loss"]], [eager["seed_loss"]]):
        diffs.append("seed loss")
    for key in ("loss", "lr", "is_real_update"):
        if not same_values([r[key] for r in cap["round_log"]],
                           [r[key] for r in eager["round_log"]]):
            diffs.append(f"round {key}")
    bad = [i for i, (a, b) in enumerate(zip(cap["fingerprint"], eager["fingerprint"])) if a != b]
    if bad:
        diffs.append(f"state leaves {bad}")
    return diffs


@contextlib.contextmanager
def graph_fault(kind: str):
    """A planted fault in the captured rounds (``compile/graphs.py``):
    'block' drops the copy of each round's block into the static block
    (every replay reads a stale block); 'slot' drops the copy of the
    metric vector into the round's slot (rounds read back together all
    show the last one's); 'phase' swaps the buffer sets out of phase
    once, before round 3 (a round reads the set its previous round did
    not write)."""
    from acco_tpu_torch.compile.graphs import RoundPrograms

    saved = {name: getattr(RoundPrograms, name) for name in ("load_block", "slot", "run")}
    if kind == "block":
        RoundPrograms.load_block = lambda self, block: None
    elif kind == "slot":
        RoundPrograms.slot = lambda self, vec: vec
    else:
        run = saved["run"]

        def swapped(self, block, parity, quiet=contextlib.nullcontext):
            self.rounds_run = getattr(self, "rounds_run", 0) + 1
            if self.rounds_run == 4:
                self.phases = tuple(1 - p for p in self.phases)
            return run(self, block, parity, quiet)

        RoundPrograms.run = swapped
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(RoundPrograms, name, value)


def fresh_build_start(warmup: bool, empty: bool = True) -> tuple:
    """Llama-125M started with no kernel library loaded: built into an
    empty build directory (git-ignored, removed after), or with ``empty``
    false loaded from the build cache, ``train.warmup_compile`` true
    (built in the background from the constructor on, every program
    captured before the first round) or false (built or loaded at first
    use, each program captured after its first round); returns the
    seconds from the trainer's constructor to the first round read back,
    round 0's synced ms and the compile report."""
    from pathlib import Path

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.utils import cuda_build

    saved = cuda_build.BUILD_DIR, dict(cuda_build._LOADED), dict(cuda_build.BUILD_INFO)
    fresh = tempfile.mkdtemp(prefix="fresh_", dir=os.path.join(REPO, "build")) if empty else None
    if empty:
        cuda_build.BUILD_DIR = Path(fresh)
    cuda_build._LOADED.clear()
    cuda_build.BUILD_INFO.clear()
    try:
        free_device_cache()
        trainer = build_trainer([*main_args("llama-125M"),
                                 f"train.warmup_compile={'true' if warmup else 'false'}"])
        summary = trainer.train()
        del trainer
    finally:
        cuda_build.BUILD_DIR = saved[0]
        cuda_build._LOADED.clear()
        cuda_build._LOADED.update(saved[1])
        cuda_build.BUILD_INFO.clear()
        cuda_build.BUILD_INFO.update(saved[2])
        if fresh:
            shutil.rmtree(fresh, ignore_errors=True)
    return (summary["init_to_first_round_s"], summary["round_log"][0]["ms"],
            summary["compile_report"])


def phase_11(smi: str, sg, round_ms: dict, summaries: dict, launches: dict, profiles: dict,
             cadence: dict, drills: dict) -> dict:
    """The rounds captured and replayed against eager rounds: (a) each
    phase-5 cell again with its rounds as eager calls, bit-equal
    (losses, LRs, flags, the final state) and with the same launch counts;
    (b) three planted faults in the captured rounds that the check must
    catch; (c) per cell, captured against eager: synced median round ms,
    idle share and device ms a microbatch (profiled reruns), the host's
    launch calls and graph launches and the device's kernels a round,
    peak allocated and reserved, allocator retries, capture and warm-up
    join ms; Llama-125M and its fused-CE cell at cadence 10; the time to
    the first round with warmup_compile true from a fresh build
    directory and false from the build cache; (d) a drill, a rollback and a SIGTERM resume,
    captured, against their eager oracles. ``cadence``: phase 8 (d)'s
    captured cadence runs, path -> (mean round ms, round losses). Returns
    the eager runs' launches."""
    from acco_tpu_torch.__main__ import build_trainer

    out: dict = {}
    eager: dict = {}
    log(" (a) every cell again with its rounds as eager calls (build_trainer(..., eager=True))")
    for path in (*MAIN_PATHS, *RING_PATHS, *DP_PATHS):
        group = sg.group if path in DP_PATHS else None
        la, med, _, s = main_path(path, sg if path in RING_PATHS else None, group, eager=True)
        out[f"{path}-eager"] = la
        diffs = captured_vs_eager(path, summaries[path], s)
        same_launches = la == launches[path]
        log(f"  {path}: captured against eager: "
            f"{'bit-equal (losses, LRs, flags, final state)' if not diffs else 'DIFFER in ' + str(diffs)}; "
            f"launch counts {'equal' if same_launches else 'DIFFER: ' + str(la) + ' eager'}")
        if not same_launches:
            raise AssertionError(f"{path}: launches under replay {launches[path]}, eager {la}")
        if diffs and path in BIT_EQUAL_PATHS:
            raise AssertionError(f"{path}: captured rounds differ from eager: {diffs}")
        if diffs:  # the long and ring cells: held to the ring's loss bar
            cap = [summaries[path]["seed_loss"]] + [r["loss"] for r in summaries[path]["round_log"]]
            eag = [s["seed_loss"]] + [r["loss"] for r in s["round_log"]]
            worst = max(abs(a - b) / abs(b) for a, b in zip(cap, eag))
            log(f"    largest relative loss difference {worst:.3e} (bar {RING_LOSS_RTOL:g})")
            if worst > RING_LOSS_RTOL:
                raise AssertionError(f"{path}: captured losses off eager's by {worst:.3e}")
        prof = (profile_main_path(path, med, sg=sg, group=sg.group, eager=True)
                if path in EAGER_PROFILED_PATHS else None)
        eager[path] = (med, s, prof)

    log(f" (b) planted faults in the captured rounds of {GRAPH_FAULT_PATH}, against its eager run")
    ref = eager[GRAPH_FAULT_PATH][1]
    # the slot fault shows once a read-back window outlasts the program
    # cycle (4 programs for ACCO, each with its own metric vector): read
    # back once, after all the rounds
    for kind, cad in (("block", 1), ("slot", MAIN_ROUNDS), ("phase", 1)):
        free_device_cache()
        with graph_fault(kind):
            trainer = build_trainer(main_args(GRAPH_FAULT_PATH, cad))
            s = trainer.train()
            s["fingerprint"] = state_fingerprint(trainer.final_state)
            del trainer
        diffs = captured_vs_eager(GRAPH_FAULT_PATH, s, ref)
        what = {"block": "the block copy dropped (a stale block)",
                "slot": f"the metric-slot copy dropped (read back every {MAIN_ROUNDS} rounds)",
                "phase": "the buffer sets swapped out of phase before round 3"}[kind]
        log(f"  {what}: {'caught, differs in ' + str(diffs) if diffs else 'NOT caught'}"
            + (f"; round losses {[round(r['loss'], 5) for r in s['round_log']]}"
               if kind == "slot" else ""))
        if not diffs:
            raise AssertionError(f"the captured-rounds check missed the planted fault {kind!r}")

    log(f" (c) captured against eager, by cell, on {smi} (profiled: phase 7's cells captured, "
        f"{', '.join(EAGER_PROFILED_PATHS)} eager)")

    def both(prof_c, prof_e, key: str, fmt: str) -> str:
        return " / ".join("not profiled" if p is None else format(p[key], fmt)
                          for p in (prof_c, prof_e))

    for path in (*MAIN_PATHS, *RING_PATHS, *DP_PATHS):
        cap, (med_e, s_e, prof_e) = summaries[path], eager[path]
        prof_c = profiles.get(path)
        report = cap["compile_report"]
        capture_ms = sum(r["capture_ms"] or 0.0 for r in report["programs"].values())
        rise = cap["peak_bytes"] / s_e["peak_bytes"] - 1
        log(f"  {path}: median round ms {round_ms[path]:.2f} / {med_e:.2f}; idle share "
            f"{both(prof_c, prof_e, 'idle_share', '.3f')}; device ms a microbatch "
            f"{both(prof_c, prof_e, 'union_ms_per_microbatch', '.2f')}; "
            f"a round: kernel launch calls {both(prof_c, prof_e, 'kernel_launch_calls', '.1f')}, "
            f"graph launches {both(prof_c, prof_e, 'graph_launches', '.1f')}, kernels "
            f"{both(prof_c, prof_e, 'kernels', '.1f')}; peak allocated "
            f"{cap['peak_bytes'] / 2**30:.2f} / "
            f"{s_e['peak_bytes'] / 2**30:.2f} GiB ({100 * rise:+.2f}%), reserved "
            f"{cap['reserved_bytes'] / 2**30:.2f} / {s_e['reserved_bytes'] / 2**30:.2f} GiB, "
            f"allocator retries {cap['retries']} / {s_e['retries']}; captures "
            f"{len(report['programs'])} in {capture_ms:.1f} ms, train_warmup_join_ms "
            f"{report['warmup_join_ms']:.1f} (captured / eager)")
        if rise > PEAK_RISE:
            raise AssertionError(f"{path}: captured peak {cap['peak_bytes']} is {100 * rise:.2f}% "
                                 f"over eager's {s_e['peak_bytes']}")
        if path in LONG_PATHS and cap["retries"]:
            raise AssertionError(f"{path}: {cap['retries']} allocator retries under capture")
    for path in CADENCE_PATHS:
        mean_e, s_e, _ = cadence_ms(path, eager=True)
        mean_c, losses_c = cadence[path]
        same = [r["loss"] for r in s_e["round_log"]] == losses_c
        log(f"  {path} at cadence {CADENCE}: mean round ms of rounds {CADENCE + 1}-"
            f"{CADENCE_ROUNDS} captured {mean_c:.3f} / eager {mean_e:.3f}; losses "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{path}: captured and eager losses differ at cadence {CADENCE}")
    # warmup_compile=false from the build cache: its nvcc builds are the
    # same as true's, the first-use loads and late captures are its own
    for warm in (True, False):
        first_s, round0_ms, report = fresh_build_start(warm, empty=warm)
        lib = report["libraries"].get("fused_attention") or {}
        where = "an empty build directory" if warm else "the build cache"
        log(f"  llama-125M from {where}, warmup_compile={warm}: constructor to "
            f"the first round read back {first_s:.2f} s; round 0 {round0_ms:.1f} ms; background "
            f"build {lib.get('build_ms') or 0.0:.0f} ms; train_warmup_join_ms "
            f"{report['warmup_join_ms']:.1f}; programs captured "
            f"{sum(1 for r in report['programs'].values() if r['capture_ms'])}")

    log(" (d) a drill, a rollback and a SIGTERM resume, captured (the drills: phase 10 (c)'s "
        "runs), against eager oracles")
    for label, (extra, nb) in DRILLS.items():
        runs = {"captured": drills[label]}
        free_device_cache()
        trainer = build_trainer(p10_args(f"p11-{label}-eager", nb, *extra), eager=True)
        s = trainer.train()
        s["fingerprint"] = state_fingerprint(trainer.final_state)
        runs["eager"] = s
        del trainer
        diffs = captured_vs_eager(label, runs["captured"], runs["eager"])
        log(f"  {label}: skipped {runs['captured']['skipped_rounds']} / "
            f"{runs['eager']['skipped_rounds']}, rollbacks {runs['captured']['rollbacks']} / "
            f"{runs['eager']['rollbacks']} (captured / eager): "
            f"{'bit-equal' if not diffs else 'DIFFER in ' + str(diffs)}")
        if diffs or runs["captured"]["rounds_as"] != "captured":
            raise AssertionError(f"{label}: captured against eager {diffs}")
    free_device_cache()
    stop = build_trainer(p10_args("p11-sigterm", P10_ROUNDS, "train.save=true"))
    with sigterm_after_rounds(5):
        st = stop.train()
    del stop
    resumed = build_trainer(p10_args("p11-sigterm-resume", P10_ROUNDS,
                                     f"train.resume_from={run_root()}/p10/p11-sigterm/checkpoints/acco"))
    sr = resumed.train()
    fp = state_fingerprint(resumed.final_state)
    del resumed
    free_device_cache()
    oracle = build_trainer(p10_args("p11-eager", P10_ROUNDS), eager=True)
    so = oracle.train()
    fo = state_fingerprint(oracle.final_state)
    del oracle
    same = fp == fo and same_values([r["loss"] for r in st["round_log"] + sr["round_log"]],
                                    [r["loss"] for r in so["round_log"]])
    log(f"  SIGTERM after 5 rounds (interrupted {st['interrupted']}, {st['count_grad_tot']} "
        f"grads), resumed captured to {sr['count_grad_tot']}: "
        f"{'bit-equal to the eager uninterrupted run' if same else 'DIFFERS from it'}")
    if not (st["interrupted"] and same):
        raise AssertionError("the captured SIGTERM resume differs from the eager run")
    return out


# -- phase 12: serving ---------------------------------------------------------

SERVE_CONFIG = os.path.join(REPO, "config", "serve", "llama3-8b.yaml")
# one prompt a slot, eight buckets of the replica's (4096 down to 16)
SERVE_PROMPTS = (4000, 1800, 1000, 500, 100, 50, 20, 9)
SERVE_STEPS = 32  # decode steps each way (eager, captured), bit-equal
SERVE_TIMED_STEPS = 16  # then decode + greedy sample, the scheduler's step
SERVE_PROFILE_STEPS = 8
# (b): prefill + K decode steps against one forward of the whole sequence,
# float32, TF32 off, the plain attention on both sides: only the
# summation order differs (the JAX tests hold 1e-5 on the CPU at tiny
# widths; here 12 layers of D 768 and the card's GEMMs)
SERVE_PARITY_ATOL = 1e-4
SERVE_PARITY = dict(n_prompt=601, n_decode=40, page_size=16, max_pages_per_seq=64)
SERVE_FAMILIES = {"llama-125M": "llama-125M", "gptneo": "gptneo"}  # config/model/<name>.yaml
SERVE_HTTP_SECONDS = 10
SERVE_HTTP_CONCURRENCY = 8
SERVE_DRAIN_BUDGET_S = 30.0
# (d)'s replica: Llama-125M, bf16 params and cache, context 1024, 8 slots
SERVE_HTTP_MODEL = "llama-125M"
SERVE_HTTP_SIZING = dict(page_size=16, num_pages=1024, max_pages_per_seq=64, max_slots=8)
# the card; 'cpu' (with smaller sizes above) runs phase 12's logic on the
# CPU, the entry point with --device cpu
SERVE_DEVICE = "cuda"


def _serve_sync() -> None:
    import torch

    if SERVE_DEVICE == "cuda":
        torch.cuda.synchronize()


def serve_replica(smi: str) -> dict:
    """(a) The full-depth Llama-3-8B replica of config/serve/llama3-8b.yaml
    through ``ServeEngine`` with parameters drawn on the card from seed 0:
    one prompt in each of eight buckets, then 32 decode steps over the 8
    active slots eager and the same 32 captured (from the same pools),
    which must be bit-equal (logits and both pools), then the scheduler's
    step (decode + greedy sample) timed and a profiled window."""
    import logging

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.serve.__main__ import build_engine
    from acco_tpu_torch.serve.kv_cache import PageAllocator
    from acco_tpu_torch.telemetry.profile import load_events, read_trace

    free_device_cache()
    cuda = SERVE_DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = load_yaml(SERVE_CONFIG)
    t0 = time.perf_counter()
    engine, _ = build_engine(cfg, torch.device(SERVE_DEVICE), logging.getLogger("chip_smoke.serve"))
    model, spec = engine.model, engine.spec
    c = model.config
    log(f"  {cfg['model']} ({c.num_layers} layers, d {c.hidden_size}, heads {c.num_heads}/"
        f"{c.num_kv_heads}, vocab {c.vocab_size}): {model.n_params:,} params, "
        f"{model.n_params * 2:,} bytes bf16; pool {spec.num_pages} pages of {spec.page_size}, "
        f"{spec.total_bytes:,} bytes; context {engine.max_context}, {engine.max_slots} slots")
    report = engine.start_warmup()
    engine.set_params(model.init_flat(torch.Generator(device=SERVE_DEVICE).manual_seed(0)))
    _serve_sync()
    from acco_tpu_torch.analysis.programs import serve_state

    serve_buffers = {t.data_ptr() for t in serve_state(engine)["params"]} | {
        t.data_ptr() for t in engine.pools}
    log(f"  built, captured and initialised in {time.perf_counter() - t0:.1f} s; decode step "
        f"warm-up {report.get('warmup_ms')} ms, capture {report.get('capture_ms')} ms, "
        f"memory after capture (allocated, reserved GiB) {report.get('memory_gib')}")

    total = SERVE_STEPS * 2 + SERVE_TIMED_STEPS + SERVE_PROFILE_STEPS
    rng = np.random.default_rng(0)
    alloc = PageAllocator(engine.num_pages)
    table = np.zeros((engine.max_slots, engine.max_pages_per_seq), np.int32)
    prefill_ms, first = {}, []
    for slot, n in enumerate(SERVE_PROMPTS):
        ids = rng.integers(0, c.vocab_size, n).tolist()  # lint: host-sync-ok: host numpy ints
        pages = alloc.alloc(spec.pages_for(min(n + total + 1, engine.max_context)))
        table[slot, : len(pages)] = pages
        own = pages[: spec.pages_for(n)]
        engine.prefill(ids, own)  # this bucket's first call
        t = time.perf_counter()
        last = engine.prefill(ids, own)  # returns host logits: synced
        prefill_ms[engine.bucket_for(n)] = (time.perf_counter() - t) * 1e3
        if not np.isfinite(last).all():
            raise AssertionError(f"prefill of {n} tokens: non-finite logits")
        first.append(int(last.argmax()))
    log("  prefill ms by bucket (prompt tokens -> bucket, the second call): "
        + ", ".join(f"{n} -> {b}: {ms:.2f}" for n, (b, ms) in zip(SERVE_PROMPTS,
                                                                  prefill_ms.items())))

    lens0 = np.asarray(SERVE_PROMPTS, np.int64)
    k_pages, v_pages = engine.pools
    snapshot = (k_pages.clone(), v_pages.clone())

    def decode_run(eager: bool):
        toks, outs, times = np.asarray(first), [], []
        for s in range(SERVE_STEPS):
            _serve_sync()
            t = time.perf_counter()
            logits = engine.decode_logits(table, lens0 + s, toks, eager=eager)
            _serve_sync()
            times.append((time.perf_counter() - t) * 1e3)
            outs.append(logits.clone())
            toks = logits.argmax(-1).cpu().numpy()  # lint: host-sync-ok: a deliberate read-back the check compares
        return outs, times

    eager_out, eager_ms = decode_run(True)
    eager_pools = (k_pages.clone(), v_pages.clone())
    k_pages.copy_(snapshot[0])
    v_pages.copy_(snapshot[1])
    del snapshot
    cap_out, cap_ms = decode_run(False)
    same_logits = all(torch.equal(a, b) for a, b in zip(eager_out, cap_out))
    same_pools = torch.equal(k_pages, eager_pools[0]) and torch.equal(v_pages, eager_pools[1])
    finite = all(bool(torch.isfinite(x).all()) for x in cap_out)
    log(f"  {SERVE_STEPS} decode steps x {engine.max_slots} slots, captured against eager: "
        f"logits {'bit-equal' if same_logits else 'DIFFER'}, pools "
        f"{'bit-equal' if same_pools else 'DIFFER'}; finite {finite}; median step ms "
        f"(inputs staged, replay or eager, synced) captured {statistics.median(cap_ms):.3f}, "
        f"eager {statistics.median(eager_ms):.3f}")
    del eager_out, cap_out, eager_pools
    if not (same_logits and same_pools and finite):
        raise AssertionError("the captured decode step is not bit-equal to the eager one")

    # the scheduler's step: decode (host logits) + greedy sample
    lens = lens0 + SERVE_STEPS
    toks = np.asarray(first)
    keys = np.stack([engine.make_key(s) for s in range(engine.max_slots)])
    temps = np.zeros(engine.max_slots, np.float32)
    top_ks = np.zeros(engine.max_slots, np.int32)
    step_ms = []
    for _ in range(SERVE_TIMED_STEPS):
        t = time.perf_counter()
        logits = engine.decode(table, lens, toks)
        toks, keys = engine.sample(logits, keys, temps, top_ks)
        step_ms.append((time.perf_counter() - t) * 1e3)
        lens = lens + 1
    step = statistics.median(step_ms)

    _serve_sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for _ in range(SERVE_PROFILE_STEPS):
            engine.decode(table, lens, toks)
            lens = lens + 1
        _serve_sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    trace = os.path.join(run_root(), "serve_decode_trace.json")
    prof.export_chrome_trace(trace)
    st = read_trace(load_events(trace), wall_ms, SERVE_PROFILE_STEPS)
    top = serve_top_kernels(prof, SERVE_PROFILE_STEPS)
    # the smallest bucket's prefill, profiled: host-bound or device-bound
    ids = rng.integers(0, c.vocab_size, SERVE_PROMPTS[-1]).tolist()
    own = [int(table[-1, 0])]
    _serve_sync()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        engine.prefill(ids, own)
        prefill_wall = (time.perf_counter() - t) * 1e3
    prof.export_chrome_trace(trace)
    pst = read_trace(load_events(trace), prefill_wall)
    peak, reserved = ((torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
                      if cuda else (0, 0))
    out = {
        "prefill_ms": prefill_ms, "decode_ms": statistics.median(cap_ms),
        "eager_decode_ms": statistics.median(eager_ms), "step_ms": step,
        "tokens_per_s": engine.max_slots * 1e3 / step, "capture_ms": report.get("capture_ms"),
        "launch_calls": st.get("kernel_launch_calls"), "graph_launches": st.get("graph_launches"),
        "kernels": st.get("kernels"), "device_ms": st.get("union_ms"),
        "idle_share": st.get("idle_share"), "peak_bytes": peak, "reserved_bytes": reserved,
        "pool_bytes": spec.total_bytes, "param_bytes": model.n_params * 2,
        "top_kernels": top, "small_prefill": {"wall_ms": prefill_wall,
                                              "device_ms": pst.get("union_ms")},
    }
    log(f"  the scheduler's step (decode + greedy sample, host logits) median {step:.3f} ms: "
        f"{out['tokens_per_s']:.1f} tokens/s at {engine.max_slots} slots")
    log(f"  profiled window, {SERVE_PROFILE_STEPS} decode steps: a step {st.get('wall_ms', 0):.3f} "
        f"ms wall, device busy {st.get('union_ms', 0):.3f} ms, idle share "
        f"{st.get('idle_share', float('nan')):.4f}; kernel launch calls "
        f"{st.get('kernel_launch_calls')}, graph launches {st.get('graph_launches')}, kernels "
        f"{st.get('kernels')} a step")
    log(f"  device time a decode step by kernel (the window's top 8): {top}")
    log(f"  prefill at bucket {engine.bucket_for(SERVE_PROMPTS[-1])}, profiled: {prefill_wall:.2f} ms "
        f"wall, device busy {pst.get('union_ms', 0):.2f} ms, {pst.get('kernels')} kernels, "
        f"kernel launch calls {pst.get('kernel_launch_calls')}")
    log(f"  peak allocated {peak:,} bytes ({peak / 2**30:.2f} GiB), reserved {reserved:,} "
        f"({reserved / 2**30:.2f} GiB); pool {spec.total_bytes:,}, params "
        f"{model.n_params * 2:,} bytes  [{smi}]")
    serve_state_gates("serve-llama3-8b", engine, serve_buffers)
    del engine, model, k_pages, v_pages
    free_device_cache()
    return out


def serve_top_kernels(prof, steps: int, n: int = 8) -> str:
    """The ``n`` kernels with the most device time in a profile, as
    'name ms a step (calls a step)'."""
    def device_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted((e for e in prof.key_averages() if device_us(e) > 0), key=device_us,
                  reverse=True)[:n]
    return "; ".join(f"{e.key[:70]} {device_us(e) / 1e3 / steps:.3f} ms (x{e.count / steps:g})"
                     for e in rows)


def serve_parity_model(name: str):
    """The float32 model of config/model/<name>.yaml on the card (the plain
    attention) and a flat parameter vector drawn from seed 0."""
    import torch

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model

    model_cfg = load_yaml(os.path.join(REPO, "config", "model", name + ".yaml"))
    model = build_model(model_cfg, repo_root=REPO, dtype=torch.float32, attention="xla",
                        device=SERVE_DEVICE)
    return model, model.init_flat(torch.Generator(device=SERVE_DEVICE).manual_seed(0))


def serve_parity(model, flat, *, use_band=None, engine_cls=None) -> tuple:
    """Prefill + K decode steps through a captured ``ServeEngine`` against
    one ``apply`` over the whole sequence (float32, TF32 off): returns
    (the max |difference| over the K decode logits and the prefill's
    last, the decode logits). ``use_band`` forces GPT-Neo's lane."""
    import numpy as np
    import torch

    from acco_tpu_torch.serve.engine import ServeEngine

    p = SERVE_PARITY
    n, k, page = p["n_prompt"], p["n_decode"], p["page_size"]
    engine = (engine_cls or ServeEngine)(
        model, page_size=page, num_pages=p["max_pages_per_seq"] + 2,
        max_pages_per_seq=p["max_pages_per_seq"], max_slots=2, cache_dtype="float32")
    if use_band is not None:
        engine._use_band = use_band
    engine.start_warmup()
    engine.set_params(flat)
    ids = np.random.default_rng(1).integers(0, model.config.vocab_size, n + k)
    with torch.no_grad():
        ref = model.apply(torch.from_numpy(ids[None]).to(SERVE_DEVICE))[0]
    pages = list(range(1, -(-(n + k) // page) + 1))
    last = torch.from_numpy(engine.prefill(ids[:n].tolist(), pages[: -(-n // page)])).to(SERVE_DEVICE)
    err = float((last - ref[n - 1]).abs().max())
    table = np.zeros((2, p["max_pages_per_seq"]), np.int32)
    table[0, : len(pages)] = pages
    outs = []
    for t in range(k):
        logits = engine.decode_logits(table, np.array([n + t, 0]), np.array([ids[n + t], 0]))
        outs.append(logits[0].clone())
        err = max(err, float((logits[0] - ref[n + t]).abs().max()))
    return err, torch.stack(outs)


def rebound_page_table_engine(*args, **kwargs):
    """Planted fault: a ``ServeEngine`` whose step rebinds its page table
    to a new tensor instead of copying it into the captured buffer (the
    graph keeps reading the old one)."""
    import numpy as np
    import torch

    from acco_tpu_torch.serve.engine import ServeEngine

    class Engine(ServeEngine):
        def _stage(self, page_table, seq_lens, tokens):
            dev = self._ensure_inputs()["dev"]
            dev["page_table"] = torch.as_tensor(np.asarray(page_table, np.int64),
                                                device=self.device)
            dev["seq_lens"].copy_(torch.as_tensor(np.asarray(seq_lens, np.int64)))
            dev["tokens"].copy_(torch.as_tensor(np.asarray(tokens, np.int64)))

    return Engine(*args, **kwargs)


@contextlib.contextmanager
def serve_fault(kind: str):
    """Planted faults in the serving path's ops, patched into the engine's
    module for the block: 'write_token' writes each new K/V row one
    position late; 'band' gathers each band from one page later."""
    from acco_tpu_torch.serve import engine as engine_mod

    name = {"write_token": "write_token", "band": "gather_band"}[kind]
    original = getattr(engine_mod, name)
    if kind == "write_token":
        def planted(k_pages, v_pages, page_table, seq_lens, k_new, v_new):
            return original(k_pages, v_pages, page_table, seq_lens + 1, k_new, v_new)
    else:
        def planted(k_pages, v_pages, page_table, seq_lens, window, page_size):
            return original(k_pages, v_pages, page_table, seq_lens + page_size, window,
                            page_size)
    setattr(engine_mod, name, planted)
    try:
        yield
    finally:
        setattr(engine_mod, name, original)


def serve_parity_phase() -> dict:
    """(b) and (c): both 125M families in float32 (GPT-Neo at window 256:
    the band lane, its full lane beside it), then the planted faults."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for label, name in SERVE_FAMILIES.items():
            model, flat = serve_parity_model(name)
            err, outs = serve_parity(model, flat)
            errs[label] = err
            log(f"  {label}: prefill {SERVE_PARITY['n_prompt']} + {SERVE_PARITY['n_decode']} "
                f"decode steps (page {SERVE_PARITY['page_size']}, context "
                f"{SERVE_PARITY['page_size'] * SERVE_PARITY['max_pages_per_seq']}) against one "
                f"forward: max |err| {err:.3e} (bar {SERVE_PARITY_ATOL:g})")
            if not err <= SERVE_PARITY_ATOL:
                raise AssertionError(f"{label}: the serving path is off the forward by {err:.3e}")
            if label == "gptneo":
                full_err, full = serve_parity(model, flat, use_band=False)
                lanes = float((outs - full).abs().max())
                errs["gptneo_full_lane"] = full_err
                errs["gptneo_lanes"] = lanes
                log(f"  gptneo full-context lane: max |err| {full_err:.3e}; band lane against "
                    f"full lane {lanes:.3e} (bar {SERVE_PARITY_ATOL:g})")
                if not (full_err <= SERVE_PARITY_ATOL and lanes <= SERVE_PARITY_ATOL):
                    raise AssertionError("GPT-Neo's band and full lanes disagree")
                neo = (model, flat)
            else:
                llama = (model, flat)
        faults = [
            ("write_token one position late", llama, serve_fault("write_token"), {}),
            ("the band's first page one late", neo, serve_fault("band"), {}),
        ]
        if SERVE_DEVICE == "cuda":  # only a captured step reads a stale buffer
            faults.insert(0, ("page table rebound, not copied", llama,
                              contextlib.nullcontext(), {"engine_cls": rebound_page_table_engine}))
        for label, (model, flat), ctx, kw in faults:
            with ctx:
                err, _ = serve_parity(model, flat, **kw)
            caught = not err <= SERVE_PARITY_ATOL
            log(f"  planted fault, {label}: max |err| {err:.3e}: "
                f"{'caught' if caught else 'MISSED'}")
            if not caught:
                raise AssertionError(f"the serving parity check missed a planted fault: {label}")
            errs[f"fault: {label}"] = err
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        free_device_cache()
    return errs


def serve_http_start() -> dict:
    """Start (d)'s server: ``python -m acco_tpu_torch.serve`` on the card
    serving a Llama-125M ``params.npz`` written here (seeded init, bf16
    params and cache, 8 slots, context 1024), in a process of its own, so
    that its start overlaps (b) and (c)."""
    import socket

    import numpy as np
    import torch

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    atexit.register(shutil.rmtree, tmp, True)
    step = os.path.join(tmp, "ckpt", "step_1")
    os.makedirs(os.path.join(step, "state"))
    model = build_model(load_yaml(os.path.join(REPO, "config", "model",
                                               SERVE_HTTP_MODEL + ".yaml")),
                        repo_root=REPO, dtype=torch.float32, device=SERVE_DEVICE)
    flat = model.init_flat(torch.Generator(device=SERVE_DEVICE).manual_seed(0)).cpu().numpy()
    del model
    np.savez(os.path.join(step, "params.npz"), flat_params=flat)
    with open(os.path.join(step, "meta.json"), "w") as f:
        json.dump({"step": 1}, f)
    # the model's architecture file with the byte tokenizer, which its hub
    # tokenizer falls back to on a machine without its files (the server
    # then starts without importing transformers)
    model_yaml = load_yaml(os.path.join(REPO, "config", "model", SERVE_HTTP_MODEL + ".yaml"))
    with open(os.path.join(tmp, "model.yaml"), "w") as f:
        f.write(f"config_path: \"{model_yaml['config_path']}\"\ntokenizer: byte\n")
    config = os.path.join(tmp, "serve.yaml")
    sizing = "".join(f"{k}: {v}\n" for k, v in SERVE_HTTP_SIZING.items())
    with open(config, "w") as f:
        # an absolute `model:` names that file (config/model/<model>.yaml otherwise)
        f.write(f"model: {os.path.join(tmp, 'model')}\nparam_dtype: bfloat16\n"
                "cache_dtype: bfloat16\n"
                + sizing + "prefills_per_step: 1\ntop_k_max: 64\nhost: 127.0.0.1\n"
                "request_timeout_s: 120\n"
                f"max_waiting: 64\nkv_watermark: 0.95\ndrain_budget_s: {SERVE_DRAIN_BUDGET_S}\n"
                "defaults:\n  max_new_tokens: 32\n  temperature: 0.0\n  top_k: 0\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    err_path = os.path.join(tmp, "server.log")
    device = [] if SERVE_DEVICE == "cuda" else ["--device", SERVE_DEVICE]
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "acco_tpu_torch.serve", "--config", config,
             "--resume_from", os.path.dirname(step), "--port", str(port), *device],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True)
    return {"proc": proc, "url": f"http://127.0.0.1:{port}", "tmp": tmp, "t0": t0,
            "log": err_path}


def serve_http_phase(smi: str, server: dict) -> dict:
    """(d) The load harness against ``server`` in ``--url`` mode (no 500,
    no page in use once the clients are done), then 8 requests in flight
    and SIGTERM: the drain must finish them within its budget and the
    server exit 0. Kills the server if a check fails first."""
    import threading

    import numpy as np

    from acco_tpu_torch.serve.load_harness import _http

    proc, url, tmp, t0, err_path = (server[k] for k in ("proc", "url", "tmp", "t0", "log"))
    ctx = SERVE_HTTP_SIZING["page_size"] * SERVE_HTTP_SIZING["max_pages_per_seq"]
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited ({proc.returncode}) before serving: "
                                     f"{open(err_path).read()[-3000:]}")
            try:
                if _http(url + "/healthz", timeout=2.0)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 240:
                raise AssertionError("the server did not answer /healthz within 240 s")
            time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        with open(err_path) as f:
            for line in f:
                if "serve decode step:" in line:
                    log("  server: " + line.strip().split("] - ", 1)[-1])
        record_path = os.path.join(tmp, "load.json")
        # the clients in a process of their own: threads of this one share
        # its interpreter lock with whatever it still runs
        harness = subprocess.run(
            [sys.executable, "-m", "acco_tpu_torch.serve.load_harness", "--url", url,
             "--duration-s", str(SERVE_HTTP_SECONDS), "--concurrency",
             str(SERVE_HTTP_CONCURRENCY), "--no-drain", "--prompt-len", "16", str(ctx // 2),
             "--max-new", "16", "128", "--out", record_path],
            cwd=REPO, capture_output=True, text=True, timeout=SERVE_HTTP_SECONDS + 300)
        if harness.returncode != 0 or not os.path.exists(record_path):
            raise AssertionError(f"the load harness failed ({harness.returncode}): "
                                 f"{harness.stderr[-3000:]}")
        with open(record_path) as f:
            record = json.load(f)
        log(f"  server ready in {ready_s:.1f} s; load harness, {SERVE_HTTP_SECONDS} s at "
            f"concurrency {SERVE_HTTP_CONCURRENCY}: {record['requests']} requests, 200 "
            f"{record['ok_200']}, 500 {record['server_500']}, shed {record['shed_429']} + "
            f"{record['shed_503']}, 504 {record['timeout_504']}; {record['tokens_per_s']} "
            f"tokens/s; TTFT p50 {record['p50_ttft_ms']} ms, p99 {record['p99_ttft_ms']} ms; "
            f"latency p50 {record['p50_latency_ms']} ms, p99 {record['p99_latency_ms']} ms; "
            f"pages in use after {record['leaked_pages']}  [{smi}]")
        if record["server_500"] or record["leaked_pages"] or not record["ok_200"]:
            raise AssertionError(f"the HTTP drill failed: {record}")
        # in flight, then SIGTERM: the drain finishes them within budget
        results = []
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 256, ctx // 16 * (2 + i)).tolist() for i in range(8)]

        def hit(prompt):
            results.append(_http(url + "/generate", {
                "tokens": prompt, "max_new_tokens": 96}, timeout=SERVE_DRAIN_BUDGET_S + 60))

        threads = [threading.Thread(target=hit, args=(p,)) for p in prompts]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            if _http(url + "/healthz")[1].get("active", 0) > 0:
                break
            time.sleep(0.02)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=SERVE_DRAIN_BUDGET_S + 60)
        exit_s = time.perf_counter() - t_term
        for t in threads:
            t.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    summary = json.loads(out.strip().splitlines()[-1])
    drain, stats = summary["drain"], summary["stats"]
    statuses = sorted(s for s, _ in results)
    log(f"  SIGTERM with {len(threads)} requests in flight: exit {proc.returncode} after "
        f"{exit_s:.2f} s; drain {drain}; the in-flight requests {statuses}; pages in use "
        f"{stats['pages_in_use']}, completed {stats['completed']}, decode steps "
        f"{stats['decode_steps']}")
    if (proc.returncode != 0 or not drain or not drain["in_budget"] or drain["cancelled"]
            or stats["pages_in_use"] or statuses != [200] * len(threads)):
        raise AssertionError("the SIGTERM drain failed")
    return {"ready_s": ready_s, "record": record, "drain": drain, "exit_s": exit_s}


def phase_12(smi: str) -> dict:
    """Serving: (b) parity on both 125M families and (c) its planted
    faults while (d)'s server starts, (d) the entry point and HTTP, then
    (a) the Llama-3-8B replica alone on the card."""
    # the earlier phases' cached blocks back to the card first: the
    # server is another process, and a card left near full by this one
    # would make its allocator free and retry (synchronizing) every step
    free_device_cache()
    server = serve_http_start()  # starts beside (b) and (c)
    try:
        log(" (b) parity against the forward, float32, TF32 off; (c) planted faults")
        parity = serve_parity_phase()
        log(" (d) python -m acco_tpu_torch.serve and its load harness over HTTP")
        http = serve_http_phase(smi, server)
    finally:
        if server["proc"].poll() is None:
            server["proc"].kill()
            server["proc"].wait()
    log(" (a) the Llama-3-8B serving replica (config/serve/llama3-8b.yaml, full depth, random "
        "init from seed 0)")
    replica = serve_replica(smi)
    return {"replica": replica, "parity": parity, "http": http}


# -- phase 13: tensor parallelism ------------------------------------------------
#
# (a) K3's vocab-parallel wrapper at its real shapes, the tp shards
# emulated in one process: each shard's K3 on its [V/tp, D] slice of the
# padded head (random padding rows), its v_real clipped and its targets
# localised with the -1 sentinel by the wrapper's own per-shard step
# (ops/fused_ce.py vp_shard_ce at each rank), the slices combined by the
# wrapper's own combine (vp_combine, its reductions over the shard axis),
# held against K3 over
# the whole unpadded vocab and against the plain version emulated alike,
# at K3's bars (lse and true logit 1e-4 + 1e-5 |ref|; dH and dW
# elementwise 2^-6 |ref| + 2^-6 of a product bound); three planted faults
# that the bars must fail; per-shard kernel times beside the bound (2 N D
# V/tp operations a pass) and the materialized vocab-parallel CE.
VP_HEADS = {
    # GPT-Neo-125M's head: batch 8 x 1024 rows, vocab 50257 padded to 50304
    "gptneo-125M": dict(N=8192, D=768, V=50257, smoothing=0.1, ignore=0.02),
    # Llama-3-8B's head at the long path's 8192 rows (tp divides 128256)
    "llama3-8B": dict(N=8192, D=4096, V=128256, smoothing=0.0, ignore=0.0),
    # Llama-3-8B's head at phase 15's stage (batch 4 x seq 512 rows): one
    # shard, as the stage's one-rank (pp, tp) group runs it, and the
    # preset's pp x tp = 16 (8016 columns a shard, not a multiple of 128)
    "llama3-8B-stage": dict(N=2048, D=4096, V=128256, smoothing=0.0, ignore=0.0, tps=(1, 16)),
}
VP_TPS = (2, 4)  # the shard counts of a head that names none
VP_FAULT_HEAD, VP_FAULT_TP = "gptneo-125M", 2
VP_FAULTS = {
    "v_real": "the last shard's v_real not clipped (the padding in its LSE)",
    "targets": "the targets left global on every shard (not localised, no sentinel)",
    "dh_sum": "the sum of dH over the shards dropped (shard 0's alone)",
}
# (b) the tp paths end to end at full width, through a one-rank NCCL
# tensor group handed to build_trainer: the layers' all-reduces, the
# vocab-parallel loss through the wrapper and ZeRO-1's tp terms at tp 1,
# held against phase 5's dense cells on the same seed and batches
TP_PATHS = {
    "llama3-8B-L8192-tp": dict(MAIN_PATHS["llama3-8B-L8192"], base="llama3-8B-L8192",
                               per_microbatch={**MAIN_PATHS["llama3-8B-L8192"]["per_microbatch"],
                                               "vp_ce": 1}),
    # GPT-Neo-125M with the wrapper: fused_loss=pallas (its dense cell runs
    # the materialized CE: the losses are held to the ring's bar)
    "gptneo-tp": dict(MAIN_PATHS["gptneo"], base="gptneo", extra=["train.fused_loss=pallas"],
                      head_logits=0, fused_loss="pallas",
                      per_microbatch={**MAIN_PATHS["gptneo"]["per_microbatch"],
                                      **dict.fromkeys(_K3, 1), "vp_ce": 1}),
}


# Phase 14: pipeline parallelism at pp 1 through a one-rank NCCL pipeline
# group handed to build_trainer: the GPipe tick loop, its per-tick
# recompute (every forward kernel of a tick launched once more in the
# backward, the wrapper's K3 forward included), the masked broadcast, the
# vocab-parallel lookup and CE over the group and ZeRO-1's terms over it.
# (a) GPT-Neo-2.7B cut to one stage of its {dp: 2, pp: 4} preset, dense
# and through the pipeline (remat true: each layer's forward twice dense,
# three times under the tick's recompute); (b) the long-context Llama-3-8B
# cell through the pipeline, against phase 5's dense cell.
_NEO27 = dict(model="gptneo", neo27=True, extra=["train.fused_loss=pallas", "train.remat=true"],
              batch=8, seq=1024, n_acc=4, d_model=2560, embed_params=0,
              windows=[0, NEO_WINDOW] * (NEO27_LAYERS // 2), head_logits=0,
              fused_loss="pallas", attention="fused")


def _neo27_launches(forwards: int, ce_forwards: int, vp: int) -> dict:
    half = NEO27_LAYERS // 2  # global layers (K1), local layers (K2)
    return {"attn_fwd": forwards * half, "attn_bwd_delta": NEO27_LAYERS, "attn_bwd_dkdv": half,
            "attn_bwd_dq": half, "banded_fwd": forwards * half, "banded_bwd_dq": half,
            "banded_bwd_dkdv": half, "ce_fwd": ce_forwards, "ce_bwd_dp": 1, "ce_bwd_dh": 1,
            "ce_bwd_dw": 1, "vp_ce": vp, **dict.fromkeys(_K4 + _K5, 0)}


PP_PATHS = {
    "gptneo-2.7B-stage": dict(_NEO27, per_microbatch=_neo27_launches(2, 1, 0)),
    "gptneo-2.7B-stage-pp": dict(_NEO27, base="gptneo-2.7B-stage",
                                 per_microbatch=_neo27_launches(3, 2, 2)),
    "llama3-8B-L8192-pp": dict(
        MAIN_PATHS["llama3-8B-L8192"], base="llama3-8B-L8192",
        per_microbatch={**MAIN_PATHS["llama3-8B-L8192"]["per_microbatch"],
                        "flash_fwd": 2 * LLAMA3_LAYERS, "ce_fwd": 2, "vp_ce": 2}),
}
PP_CELLS = ("gptneo-2.7B-stage-pp", "llama3-8B-L8192-pp")
# since phase 15, which holds the pp code captured against eager on three
# cells, phase 14's cells run captured only
PP_SEED_RTOL, PP_ROUND_RTOL = 1e-5, 1e-3


class PlainShardCE:
    """K3's plain version as an autograd function on any device (the
    wrapper's plain path, which the port takes for CPU tensors):
    ``ce_fwd_reference`` forward, the chunked reference backward."""

    @staticmethod
    def apply(h, w, tgt, v_real):
        import torch

        from acco_tpu_torch.ops import fused_ce as fc

        class _Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, h, w):
                lse, tl, sl = fc.ce_fwd_reference(h, w, tgt, v_real)
                ctx.save_for_backward(h, w, lse)
                return lse, tl, sl

            @staticmethod
            def backward(ctx, d_lse, d_tl, d_sl):
                h, w, lse = ctx.saved_tensors
                cot = [torch.zeros_like(lse) if c is None else c.float().contiguous()
                       for c in (d_lse, d_tl, d_sl)]
                return fc.lm_head_ce_backward_reference(h, w, tgt, v_real, lse, *cot)

        return _Plain.apply(h, w)


def vp_inputs(head: dict, tp: int, seed: int):
    """The head's inputs on the card, bf16: hidden rows (std 1), the
    padded [Vp, D] table (std 0.02, padding rows random too), global
    targets below V with ignored rows at IGNORE_INDEX."""
    import torch

    from acco_tpu_torch.ops.losses import IGNORE_INDEX
    from acco_tpu_torch.parallel.tp import pad_vocab

    g = torch.Generator(device="cuda").manual_seed(seed)
    N, D, V = head["N"], head["D"], head["V"]
    vp = pad_vocab(V, tp)
    h = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(vp, D, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    tgt = torch.randint(0, V, (N,), generator=g, device="cuda")
    ignored = torch.rand(N, generator=g, device="cuda") < head["ignore"]
    return h, w, torch.where(ignored, torch.full_like(tgt, IGNORE_INDEX), tgt)


def vp_loss(shard, targets, head: dict, reduce_max, reduce_sum):
    """The wrapper's combine of ``shard`` (the shards' lse, true logit and
    logit sum, stacked or not, and the vocab total of ``vp_shard_ce``) and
    its mean over the unignored rows."""
    from acco_tpu_torch.ops import fused_ce as fc
    from acco_tpu_torch.ops.losses import IGNORE_INDEX

    lse, per_tok = fc.vp_combine(*shard[:3], head["smoothing"], shard[3], reduce_max,
                                 reduce_sum)
    mask = (targets != IGNORE_INDEX).float()
    return lse, per_tok, (per_tok * mask).sum() / mask.sum().clamp(min=1.0)


@contextlib.contextmanager
def vp_fault(fault):
    """A planted fault in the wrapper's own per-shard step
    (``ops/fused_ce.py`` ``vp_shard_ce``): ``v_real`` every shard's whole
    slice (the last shard's padding in its LSE), ``targets`` the global
    ids on every shard (not localised, no sentinel); ``dh_sum`` and None
    patch nothing."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    saved = fc.shard_v_real, fc.shard_targets
    if fault == "v_real":
        fc.shard_v_real = lambda real_vocab, v0, v_local: v_local
    elif fault == "targets":
        fc.shard_targets = lambda t, v0, v_local: torch.where(
            t < 0, torch.full_like(t, -1), t).to(torch.int32).contiguous()
    try:
        yield
    finally:
        fc.shard_v_real, fc.shard_targets = saved


def vp_emulated(h, w, targets, head: dict, tp: int, plain: bool = False, fault=None) -> dict:
    """The tp shards in one process: per shard the wrapper's own step
    (``vp_shard_ce`` at that rank: its v_real, its targets, the kernel or
    the plain version on its slice), the wrapper's combine over the shard
    axis, the mean loss's backward; returns lse, the true logit, the
    per-token loss, dH (summed over the shards) and dW (the shards' slices
    joined, the padding rows apart)."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    V = head["V"]
    vl = w.shape[0] // tp
    hs, ws, outs = [], [], []
    with vp_fault(fault):
        for t in range(tp):
            h_t = h.detach().clone().requires_grad_(True)
            w_t = w[t * vl:(t + 1) * vl].detach().clone().requires_grad_(True)
            outs.append(fc.vp_shard_ce(h_t, w_t, targets, t, tp, V,
                                       ce=PlainShardCE.apply if plain else None))
            hs.append(h_t)
            ws.append(w_t)
    if len({o[3] for o in outs}) != 1:
        raise AssertionError(f"the shards disagree on the vocab total: {[o[3] for o in outs]}")
    shard = (*(torch.stack([o[i] for o in outs]) for i in range(3)), outs[0][3])
    lse, per_tok, loss = vp_loss(shard, targets, head, lambda x: x.amax(0), lambda x: x.sum(1))
    loss.backward()
    dh = hs[0].grad.float() if fault == "dh_sum" else sum(x.grad.float() for x in hs)
    dw = torch.cat([x.grad for x in ws])
    return {"lse": lse.detach(), "tl": shard[1].sum(0).detach(), "per_tok": per_tok.detach(),
            "dh": dh, "dh_mass": sum(x.grad.float().abs() for x in hs), "dw": dw[:V],
            "dw_pad": dw[V:], "loss": float(loss.detach())}


def vp_reference(h, w, targets, head: dict) -> tuple:
    """K3 over the whole unpadded vocab (one shard, the same combine), and
    the bounds of its dH and dW elements (``ce_grad_terms``)."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc
    from acco_tpu_torch.ops.losses import IGNORE_INDEX

    V, ls = head["V"], head["smoothing"]
    h_r = h.detach().clone().requires_grad_(True)
    w_r = w[:V].detach().clone().requires_grad_(True)
    shard = fc.vp_shard_ce(h_r, w_r, targets, 0, 1, V)
    lse, per_tok, loss = vp_loss(shard, targets, head, lambda x: x, lambda x: x)
    loss.backward()
    mask = (targets != IGNORE_INDEX).float()
    denom = mask.sum().clamp(min=1.0)
    cot = (mask / denom, -(1.0 - ls) * mask / denom, -ls * mask / (denom * V))
    full = {"lse": lse.detach(), "tl": shard[1].detach(), "per_tok": per_tok.detach(),
            "dh": h_r.grad, "dw": w_r.grad, "loss": float(loss.detach())}
    tgt = fc.shard_targets(targets, 0, V)
    terms = ce_grad_terms(h, w[:V].contiguous(), (h, w[:V].contiguous(), tgt, V,
                                                  shard[0].detach(), *cot))
    return full, terms


def vp_check(label: str, got: dict, want: dict, terms) -> float:
    """K3's bars on the combined outputs; the padding rows' dW must be 0.
    dH is the sum of the shards' bf16 dH (as the ranks' all-reduce sums
    them), each rounded on its own: its bar's |ref| is the sum of the
    parts' magnitudes (the larger of the two sides')."""
    import torch

    log(f"  {label}")
    mass = (torch.maximum(got["dh_mass"], want["dh_mass"]) if "dh_mass" in want
            else got["dh_mass"])
    err = max(check("ce_lse", got["lse"], want["lse"]), check("ce_tl", got["tl"], want["tl"]),
              check("ce_lse", got["per_tok"], want["per_tok"]),
              check_elementwise("ce_dh", got["dh"], want["dh"], terms[0], mass=mass),
              check_elementwise("ce_dw", got["dw"], want["dw"], terms[1]))
    if bool((got["dw_pad"] != 0).any()):
        raise AssertionError(f"{label}: nonzero dW on the padding rows")
    return err


def vp_shard_timing(h, w, targets, head: dict, tp: int, group) -> dict:
    """Shard 0's K3 kernels (forward; dp + dH + dW) and their plain
    versions, the bound at 2 N D V/tp operations a pass (forward, dp, dH,
    dW) or the bytes each reads and writes, and the materialized
    vocab-parallel CE on the same slice (the head's float32 logits and
    ``vocab_parallel_causal_lm_loss``, forward and backward, its
    collectives over the one-rank ``group``)."""
    import torch

    from acco_tpu_torch.models.layers import TensorGroup, lm_logits
    from acco_tpu_torch.ops import fused_ce as fc
    from acco_tpu_torch.ops.losses import IGNORE_INDEX, vocab_parallel_causal_lm_loss

    N, D, V = head["N"], head["D"], head["V"]
    vl = w.shape[0] // tp
    w0 = w[:vl].contiguous()
    tgt0, v_real = fc.shard_targets(targets, 0, vl), fc.shard_v_real(V, 0, vl)
    mask = (targets != IGNORE_INDEX).float()
    cot = [(mask / mask.sum()).contiguous(), (-mask / mask.sum()).contiguous(),
           torch.zeros_like(mask)]
    lse0 = fc.ce_fwd(h, w0, tgt0, v_real)[0]
    fwd_ms = time_ms(lambda: fc.ce_fwd(h, w0, tgt0, v_real), iters=5, windows=3)
    bwd_ms = time_ms(lambda: fc._backward_kernels(h, w0, tgt0, v_real, lse0, cot,
                                                  fc.DP_CAP_BYTES, True, True),
                     iters=3, windows=3)
    plain_fwd = time_ms(lambda: fc.ce_fwd_reference(h, w0, tgt0, v_real), iters=1, windows=3)
    plain_bwd = time_ms(lambda: fc.lm_head_ce_backward_reference(h, w0, tgt0, v_real, lse0,
                                                                 *cot), iters=1, windows=3)
    tg = TensorGroup(group, tp, 0)  # shard 0's arithmetic; one rank's collectives
    hg, wg = h.detach().requires_grad_(True), w0.detach().requires_grad_(True)
    labels = targets.view(1, N)

    def materialized():
        loss = vocab_parallel_causal_lm_loss(lm_logits(hg.view(1, N, D), wg.t()), labels, tg,
                                             head["smoothing"], shift=False, real_vocab=V)
        return torch.autograd.grad(loss, (hg, wg))

    lib_ms = time_ms(materialized, iters=2, windows=3)
    hb, wb, rows = N * D * 2, vl * D * 2, N * 4
    dpb = N * fc.padded_vocab(vl) * 2
    ops = 2 * N * D * vl
    fwd_b = bound_ms(hb + wb + rows + 3 * rows, ops)
    bwd_b = bound_ms(2 * (hb + wb) + 5 * rows + 3 * dpb + hb + wb, 3 * ops)
    out = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "ms": fwd_ms + bwd_ms,
           "plain_ms": plain_fwd + plain_bwd, "library_ms": lib_ms,
           "fwd_bound_ms": fwd_b[0], "bound_ms": fwd_b[0] + bwd_b[0],
           "bound_by": "operations" if "operations" in (fwd_b[1], bwd_b[1]) else "bytes"}
    log(f"  shard 0 of {tp} ([{N}, {D}] x [{vl}, {D}]): forward {fwd_ms:.4f} ms (bound "
        f"{fwd_b[0]:.4f}, {fwd_b[1]}), backward {bwd_ms:.4f} ms (bound {bwd_b[0]:.4f}); "
        f"plain {out['plain_ms']:.3f} ms; materialized vocab-parallel CE (forward + backward) "
        f"{lib_ms:.3f} ms")
    del hg, wg, w0
    torch.cuda.empty_cache()
    return out


def vp_phase(group) -> tuple[dict, float]:
    """Phase 13 (a); returns the per-(head, tp) timings and the largest
    error against K3 over the whole vocab."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    times, worst = {}, 0.0
    for seed, (name, head) in enumerate(VP_HEADS.items(), start=130):
        for tp in head.get("tps", VP_TPS):
            free_device_cache()
            h, w, targets = vp_inputs(head, tp, seed)
            log(f" {name} head {head}, tp {tp}: vocab {head['V']} padded to {w.shape[0]}")
            want, terms = vp_reference(h, w, targets, head)
            kern = vp_emulated(h, w, targets, head, tp)
            worst = max(worst, vp_check("the shards' kernels, combined, against K3 over the "
                                        "whole vocab", kern, want, terms))
            plain = vp_emulated(h, w, targets, head, tp, plain=True)
            vp_check("the shards' kernels against the plain version, combined alike", kern,
                     plain, terms)
            log(f"  loss: shards {kern['loss']:.6f}  whole vocab {want['loss']:.6f}  plain "
                f"{plain['loss']:.6f}")
            if name == VP_FAULT_HEAD and tp == VP_FAULT_TP:
                for fault, what in VP_FAULTS.items():
                    bad = vp_emulated(h, w, targets, head, tp, fault=fault)
                    try:
                        vp_check(f"planted: {what}", bad, want, terms)
                    except AssertionError as exc:
                        log(f"   caught: {exc}")
                    else:
                        raise AssertionError(f"K3's bars missed the planted fault {fault!r}")
                    del bad
            del want, terms, kern, plain
            free_device_cache()
            times[f"{name} tp{tp}"] = vp_shard_timing(h, w, targets, head, tp, group)
            del h, w, targets
    return times, worst


def tp_trainer(path: str, group, extra=(), eager: bool = False):
    """The trainer of a tp path: its base path's configuration and
    ``group`` (a one-rank process group) handed in as the tensor group."""
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.parallel.mesh import RankGroups

    return build_trainer([*main_args(TP_PATHS[path]["base"]), *TP_PATHS[path]["extra"],
                          *extra], groups=RankGroups.around(tensor_group=group), eager=eager)


def phase_13(smi: str, sg, summaries: dict, round_ms: dict, peaks: dict) -> tuple:
    """Tensor parallelism: (a) the wrapper at its real shapes, shards
    emulated; (b) the tp paths through a one-rank NCCL tensor group
    against their dense cells. Returns the tp paths' launches and the
    wrapper's kernel-line entry."""
    import torch

    log(" (a) K3's vocab-parallel wrapper, 1 to 16 shards emulated in one process")
    times, worst = vp_phase(sg.group)
    launches = {}
    for path, spec in TP_PATHS.items():
        base = spec["base"]
        log(f"== 13 tp path {path}: {' '.join(main_args(base) + spec['extra'])}, a one-rank "
            "NCCL tensor group handed in")
        launches[path], med, peak, s = main_path(path, group=sg.group)
        ref = summaries[base]
        got = [s["seed_loss"]] + [r["loss"] for r in s["round_log"]]
        want = [ref["seed_loss"]] + [r["loss"] for r in ref["round_log"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        same = got == want and s["fingerprint"] == ref["fingerprint"]
        log(f"  against the dense cell {base}: losses {'bit-equal' if got == want else 'differ'}"
            f" (largest relative difference {rel:.3e}), final state "
            f"{'bit-equal' if s['fingerprint'] == ref['fingerprint'] else 'differs'}; round ms "
            f"{med:.2f} / {round_ms[base]:.2f}, peak allocated {peak / 2**30:.2f} / "
            f"{peaks[base] / 2**30:.2f} GiB (tp / dense), the wrapper's launches "
            f"{launches[path]['vp_ce']} (on {smi})")
        if spec["fused_loss"] == MAIN_PATHS[base]["fused_loss"]:
            if not same:  # the same kernels at tp 1: the combine is exact
                raise AssertionError(f"{path}: not bit-equal to {base} at tp 1")
        else:  # the wrapper (K3) against the dense cell's materialized CE
            if abs(got[0] - want[0]) > 1e-5 * abs(want[0]) or rel > RING_LOSS_RTOL:
                raise AssertionError(f"{path}: losses off {base}'s: {rel:.3e}")
    long = times["llama3-8B tp2"]
    entry = {
        "name": "vp_ce",
        "route": "cuda",
        "source": "acco_tpu_torch/ops/fused_ce.py",
        "replaces": "acco_tpu/ops/fused_ce.py:503",
        "launches": launches["llama3-8B-L8192-tp"]["vp_ce"],
        "launches_by_path": {p: launches[p]["vp_ce"] for p in launches},
        "max_abs_err": worst,
        # per shard, forward + backward, the Llama-3-8B head at tp 2; the
        # other heads and tp sizes beside it
        **{k: long[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_shape": times,
    }
    torch.cuda.empty_cache()
    return launches, entry


def pp_trainer(path: str, group, extra=(), eager: bool = False):
    """The trainer of a pp path: its dense cell's configuration and
    ``group`` (a one-rank process group) handed in as the pipeline group."""
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.parallel.mesh import RankGroups

    return build_trainer([*main_args(PP_PATHS[path]["base"]), *extra],
                         groups=RankGroups.around(pipeline_group=group), eager=eager)


def phase_14(smi: str, group, summaries: dict, round_ms: dict, peaks: dict) -> dict:
    """Pipeline parallelism at pp 1 through the one-rank NCCL ``group``:
    (a) GPT-Neo-2.7B's stage dense, then through the pipeline; (b) the
    long-context Llama-3-8B cell through the pipeline against phase 5's
    dense cell (``summaries``), captured (phase 15 holds the pp code
    captured against eager).
    Returns the launches of the cells it ran."""
    import torch

    launches = {}
    dense = "gptneo-2.7B-stage"
    log(f" (a) the cut: GPT-Neo-2.7B ({NEO27_PRESET}, the registry's widths: hidden 2560, 20 "
        f"heads of 128, vocab 50257, W 256) at {NEO27_LAYERS} of its 32 layers, the stage "
        "that config/train/acco-neo27b-v5e8.yaml's {dp: 2, pp: 4} gives one card; seq 1024, "
        "batch 8, n_acc 4, remat, fused_loss=pallas, ACCO, the seed round + "
        f"{MAIN_ROUNDS} rounds")
    log(f"== 14 dense cell {dense}: {' '.join(main_args(dense))}")
    launches[dense], round_ms[dense], peaks[dense], summaries[dense] = main_path(dense)
    for path in PP_CELLS:
        base = PP_PATHS[path]["base"]
        log(f"== 14 pp cell {path}: {' '.join(main_args(base))}, a one-rank NCCL pipeline "
            "group handed in")
        launches[path], med, peak, cap = main_path(path, group=group)
        ref = summaries[base]
        got = [cap["seed_loss"]] + [r["loss"] for r in cap["round_log"]]
        want = [ref["seed_loss"]] + [r["loss"] for r in ref["round_log"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        bit_equal = got == want and cap["fingerprint"] == ref["fingerprint"]
        n_mb = path_microbatches(path)
        per_mb = {k: launches[path][k] / n_mb for k in (*_K1, *_K2, *_K3, *_K5, "vp_ce")
                  if launches[path][k]}
        log(f"  against the dense cell {base}: losses {'bit-equal' if got == want else 'differ'}"
            f" (seed {rel[0]:.3e}, largest round {max(rel[1:]):.3e} relative), final state "
            f"{'bit-equal' if cap['fingerprint'] == ref['fingerprint'] else 'differs'}"
            f"{' (pp 1 is bit-equal to dense)' if bit_equal else ''}; round ms captured "
            f"{med:.2f}, dense {round_ms[base]:.2f}; peak allocated {peak / 2**30:.2f} GiB "
            f"(dense {peaks[base] / 2**30:.2f}), reserved "
            f"{cap['reserved_bytes'] / 2**30:.2f} GiB; launches a microbatch {per_mb} (on {smi})")
        if rel[0] > PP_SEED_RTOL or max(rel[1:]) > PP_ROUND_RTOL:
            raise AssertionError(f"{path}: losses off {base}'s: seed {rel[0]:.3e} (bar "
                                 f"{PP_SEED_RTOL}), rounds {max(rel[1:]):.3e} (bar "
                                 f"{PP_ROUND_RTOL})")
        del cap
    torch.cuda.empty_cache()
    return launches


# Phase 15: the compositions (tp x pp, pp x sp, tp x sp and the four axes)
# at every axis's size 1, through one-rank NCCL groups, one per axis,
# handed to build_trainer together: the combined (pp, tp) vocab group,
# ZeRO-1's two-segment prefix, the ring inside the pipeline's ticks and
# on a tensor shard's heads. (a) Llama-3-8B (config/model/llama-3-8B.json,
# full width, untied) cut to 2 of the 4 layers one stage of
# config/train/acco-llama3-v5e32.yaml ({dp: 2, pp: 8, tp: 2}) holds, at
# that preset's seq 512, batch 4, n_acc 8, remat 'dots' and fused_loss
# auto (K3; its wrapper under pp x tp): dense, then through pp and tp;
# under the tick's recompute K1's forward and K3's run twice a microbatch
# ('dots' saves K1's O and LSE within a tick's backward). (b) phase 5's
# long-context ring cell through dp, pp, tp and sp at once; (c) phase 5's
# GPT-Neo ring cell through (tp, sp) and (pp, sp).
_V5E32 = dict(model="llama-125M", llama3=True, extra=["train.remat=dots"], batch=4, seq=512,
              n_acc=8, d_model=4096, embed_params=128256 * 4096, windows=[0] * LLAMA3_LAYERS,
              head_logits=0, fused_loss="pallas", attention="fused")


def _v5e32_launches(forwards: int, ce_forwards: int, vp: int) -> dict:
    return {"attn_fwd": forwards * LLAMA3_LAYERS,
            **dict.fromkeys(_K1[1:], LLAMA3_LAYERS), "ce_fwd": ce_forwards,
            **dict.fromkeys(_K3[1:], 1), "vp_ce": vp, **dict.fromkeys(_K2 + _K4 + _K5, 0)}


def _recomputed(spec: dict, forwards: tuple, vp: int) -> dict:
    """A ring cell's launches under the pipeline's tick recompute: the
    forward kernels ``forwards`` twice, the wrapper ``vp`` times."""
    per = dict(spec["per_microbatch"], vp_ce=vp)
    return {k: (2 * n if k in forwards else n) for k, n in per.items()}


_BLK_FWD = ("blk_fwd_diag", "blk_fwd_full", "blk_fwd_pos", "ce_fwd")
COMPOSED_PATHS = {
    "llama3-8B-v5e32-stage": dict(_V5E32, per_microbatch=_v5e32_launches(1, 1, 0)),
    "llama3-8B-v5e32-stage-pptp": dict(
        _V5E32, args_of="llama3-8B-v5e32-stage", vs="llama3-8B-v5e32-stage", axes=("pp", "tp"),
        per_microbatch=_v5e32_launches(2, 2, 2)),
    "llama3-8B-L8192-ring-4axis": dict(
        RING_PATHS["llama3-8B-L8192-ring"], args_of="llama3-8B-L8192",
        vs="llama3-8B-L8192-ring", axes=("dp", "pp", "tp", "sp"),
        per_microbatch=_recomputed(RING_PATHS["llama3-8B-L8192-ring"], _BLK_FWD, 2)),
    "gptneo-ring-tpsp": dict(
        RING_PATHS["gptneo-ring"], args_of="gptneo", vs="gptneo-ring", axes=("tp", "sp"),
        per_microbatch=dict(RING_PATHS["gptneo-ring"]["per_microbatch"], vp_ce=1)),
    "gptneo-ring-ppsp": dict(
        RING_PATHS["gptneo-ring"], args_of="gptneo", vs="gptneo-ring", axes=("pp", "sp"),
        per_microbatch=_recomputed(RING_PATHS["gptneo-ring"], _BLK_FWD, 2),
        pos_windows={w: 2 * n for w, n in RING_PATHS["gptneo-ring"]["pos_windows"].items()}),
}
COMPOSED_CELLS = ("llama3-8B-v5e32-stage-pptp", "llama3-8B-L8192-ring-4axis", "gptneo-ring-tpsp",
                  "gptneo-ring-ppsp")
# (a) against its dense cell: the seed loss bit-equal (one tick's
# gradients, the wrapper exact at one shard), the rounds within the bf16
# tick sums' difference (autograd sums a bf16 leaf's gradient over the 8
# ticks in bf16, the dense path in float32); (b), (c): bit-equal
V5E32_ROUND_RTOL = 1e-4


def device_used_bytes() -> int:
    """The card's memory in use by this process and the driver: total
    minus free (the caching allocator's reserve, the CUDA context and
    NCCL's buffers)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free


def composed_groups(axes: tuple) -> tuple:
    """One one-rank NCCL group per axis of ``axes`` (on the one-rank
    default group), and the ``RankGroups`` around them (their comm twins,
    the world and the combined model group made there); returns
    ``((RankGroups, sequence group or None), the sequence group, the
    distinct groups)``."""
    import torch.distributed as dist

    from acco_tpu_torch.ops.ring_attention import SequenceGroup
    from acco_tpu_torch.parallel.mesh import RankGroups

    made = {axis: dist.new_group([0]) for axis in axes}
    sg = SequenceGroup.of(made["sp"]) if "sp" in made else None
    groups, _ = pair = RankGroups.around(sg, made.get("dp"), made.get("tp"), made.get("pp"))
    fields = [getattr(groups, f) for f in ("data", "world", "comm_data", "comm_world", "tensor",
                                           "comm_tensor", "all", "comm_all", "inner",
                                           "comm_inner", "pipe")]
    distinct = {id(g): g for g in [*fields, *made.values()] if g is not None}
    return pair, sg, list(distinct.values())


def phase_15(smi: str, summaries: dict, round_ms: dict, peaks: dict) -> dict:
    """The compositions at every axis's size 1 (the module's doc, 15): (a)
    the 8B preset's stage dense and through pp and tp, (b) the long ring
    cell through the four axes, (c) the GPT-Neo ring cell through (tp, sp)
    and (pp, sp). Each composed cell captured, then eager: bit-equal; (a)
    against its dense cell, (b) and (c) against phase 5's cells
    (``summaries``). Returns the launches of the cells it ran."""
    import torch
    import torch.distributed as dist

    launches = {}
    dense = "llama3-8B-v5e32-stage"
    log(f" (a) the cut: Llama-3-8B (config/model/llama-3-8B.json: hidden 4096, 32 heads, 8 KV "
        f"heads, D 128, vocab 128256, untied) at {LLAMA3_LAYERS} of the 4 layers one stage of "
        "config/train/acco-llama3-v5e32.yaml ({dp: 2, pp: 8, tp: 2}) holds, seq 512, batch 4, "
        "n_acc 8, remat 'dots', fused_loss auto, ACCO, the seed round + "
        f"{MAIN_ROUNDS} rounds")
    log(f"== 15 dense cell {dense}: {' '.join(main_args(dense))}")
    launches[dense], round_ms[dense], peaks[dense], summaries[dense] = main_path(dense)
    for path in COMPOSED_CELLS:
        spec = COMPOSED_PATHS[path]
        log(f"== 15 composed cell {path}: {' '.join(main_args(spec['args_of']))}, one-rank NCCL "
            f"groups for {', '.join(spec['axes'])} handed in")
        free_device_cache()
        used0, reserved0 = device_used_bytes(), torch.cuda.memory_reserved()
        groups, sg, comms = composed_groups(spec["axes"])
        launches[path], med, peak, cap = main_path(path, sg=sg, group=groups)
        free_device_cache()
        used1, reserved1 = device_used_bytes(), torch.cuda.memory_reserved()
        log(f"  {len(comms)} NCCL communicators (groups: {len(spec['axes'])} handed in, "
            f"{len(comms) - len(spec['axes'])} made around them); outside the allocator's reserve "
            f"{(used0 - reserved0) / 2**20:.1f} MiB before the groups, "
            f"{(used1 - reserved1) / 2**20:.1f} MiB after their first run (reserved "
            f"{reserved0 / 2**20:.1f} / {reserved1 / 2**20:.1f} MiB)")
        log(f"  {path} again, eager")
        _, med_eager, peak_eager, eager = main_path(path, sg=sg, group=groups, eager=True)
        diffs = captured_vs_eager(path, cap, eager)
        if diffs:
            raise AssertionError(f"{path}: captured rounds differ from eager: {diffs}")
        del eager
        for group in comms:  # their NCCL communicators' buffers freed
            dist.destroy_process_group(group)
        free_device_cache()
        used2 = device_used_bytes() - torch.cuda.memory_reserved()
        log(f"  the {len(comms)} groups destroyed: {used2 / 2**20:.1f} MiB outside the "
            "allocator's reserve")
        ref = summaries[spec["vs"]]
        got = [cap["seed_loss"]] + [r["loss"] for r in cap["round_log"]]
        want = [ref["seed_loss"]] + [r["loss"] for r in ref["round_log"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        state_equal = cap["fingerprint"] == ref["fingerprint"]
        leaves = [i for i, (a, b) in enumerate(zip(cap["fingerprint"], ref["fingerprint"]))
                  if a != b]
        n_mb = path_microbatches(path)
        per_mb = {k: launches[path][k] / n_mb for k in (*_K1, *_K2, *_K3, *_K4, *_K5, "vp_ce")
                  if launches[path][k]}
        log(f"  against {spec['vs']}: losses {'bit-equal' if got == want else 'differ'} (seed "
            f"{rel[0]:.3e}, largest round {max(rel[1:]):.3e} relative), final state "
            f"{'bit-equal' if state_equal else f'differs (leaves {leaves})'}; captured rounds "
            f"bit-equal to eager; "
            f"round ms captured {med:.2f}, eager {med_eager:.2f}, {spec['vs']} "
            f"{round_ms[spec['vs']]:.2f}; peak allocated {peak / 2**30:.2f} GiB (eager "
            f"{peak_eager / 2**30:.2f}, {spec['vs']} {peaks[spec['vs']] / 2**30:.2f}), reserved "
            f"{cap['reserved_bytes'] / 2**30:.2f} GiB; launches a microbatch {per_mb} (on {smi})")
        if path == "llama3-8B-v5e32-stage-pptp":
            if got[0] != want[0] or max(rel[1:]) > V5E32_ROUND_RTOL:
                raise AssertionError(f"{path}: seed loss {got[0]!r} against {want[0]!r} (must be "
                                     f"bit-equal), rounds {max(rel[1:]):.3e} (bar "
                                     f"{V5E32_ROUND_RTOL})")
        elif got != want or not state_equal:
            raise AssertionError(f"{path}: not bit-equal to {spec['vs']}")
        del cap
    torch.cuda.empty_cache()
    return launches


# -- phase 16: the static gates on the card ----------------------------------------

# each cell's verdicts (rules, dtypes, the in-place watch of its captured
# rounds), recorded by main_path and the serve replica as they run
STATE_GATES: dict = {}
# (cell, eager) -> the Chrome trace of its profiled rounds (phases 7, 11)
PROFILE_TRACES: dict = {}
SIEVE_PATHS = {"llama-125M": "llama-125M", "llama3-8B-L8192": "llama3"}
# the sieve's state bytes against the rise of memory_allocated() across
# init_state: the allocator rounds each tensor up to 512 bytes (the
# scalars: 4 bytes priced, 512 held), so the rise may exceed the sieve by
# a few KiB and must not fall short of it
SIEVE_SLACK_BYTES = 1 << 20


def train_state_gates(label: str, trainer, watched) -> None:
    """The rules and dtype verdicts over a cell's final state (its step's
    rule table, the dtype policy of its param dtype) and, for a captured
    run, what ``watch_round_programs`` saw of its rounds."""
    from acco_tpu_torch.analysis.dtypes import check_dtype_policy, train_state_rules
    from acco_tpu_torch.analysis.rules import check_rule_coverage

    state = trainer.final_state
    STATE_GATES[label] = {
        "rules": check_rule_coverage(state, trainer.step.rule_table()),
        "dtypes": check_dtype_policy(state, train_state_rules(trainer.model.dtype)),
        "watch": None if watched is None else dict(watched)}


def serve_state_gates(label: str, engine, buffers: set) -> None:
    """The serve replica's state (its parameters and pools) through the
    rules and dtype gates, and in place: every leaf still in the buffers
    it held before its captured decode steps."""
    from acco_tpu_torch.analysis.dtypes import check_dtype_policy, serve_state_rules
    from acco_tpu_torch.analysis.programs import serve_state
    from acco_tpu_torch.analysis.rules import check_rule_coverage
    from acco_tpu_torch.sharding.rules import leaf_paths

    state = serve_state(engine)
    moved = [p for p, leaf in leaf_paths(state) if leaf.data_ptr() not in buffers]
    STATE_GATES[label] = {
        "rules": check_rule_coverage(state, engine.rule_table()),
        "dtypes": check_dtype_policy(state, serve_state_rules(engine.model.dtype,
                                                              engine.spec.torch_dtype)),
        "watch": {"rounds": engine.counters["decode_steps"], "replays": None,
                  "leaves": len(leaf_paths(state)), "moved": moved}}


def sieve_vs_measured(path: str, model_name: str) -> tuple:
    """(the sieve's state bytes, the rise of ``memory_allocated()`` across
    the state's construction) for a cell's model at dp 1: the train step
    built around the model on the card, a float32 flat vector made, the
    ``AccoState`` made from it and the vector dropped (a leaf may keep
    its storage)."""
    import torch

    from acco_tpu_torch.analysis.memory import abstract_train_state, price_tree
    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.ops.schedules import get_schedule
    from acco_tpu_torch.parallel.acco import AccoTrainStep
    from acco_tpu_torch.sharding.tables import train_state_table

    cfg = load_yaml(os.path.join(REPO, "config", "model", model_name + ".yaml"))
    if path_spec(path).get("llama3"):
        cfg["config_path"] = llama3_config()
    free_device_cache()
    model = build_model(cfg, repo_root=REPO, dtype=torch.bfloat16, device="cuda")
    step = AccoTrainStep(model, get_schedule("cosine", 6e-4, 10, 100), mode="acco",
                         const_len_batch=True, weight_decay=0.1, beta1=0.9, beta2=0.95)
    predicted = sum(price_tree(abstract_train_state("acco", model.n_params),
                               train_state_table("acco", "dp"), {"dp": 1}).values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    flat = torch.zeros(model.n_params, dtype=torch.float32, device="cuda")
    state = step.init_state(flat)
    del flat
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    del state, step, model
    free_device_cache()
    return predicted, rise


def phase_16(smi: str, sg) -> None:
    """The static gates (``acco_tpu_torch/analysis/``) on the card: (a)
    rules and dtypes over the final state of every cell phases 5, 9, 11,
    13-15 ran and of phase 12's serve replica, and the in-place watch of
    every captured round (each state leaf in the two buffer sets) and of
    the replica's captured decode steps; (b) the census and the overlap
    verdict on phase 7's profiled Llama-125M rounds, read from their
    trace; (c) the program registry on the card (``analysis/programs.py``:
    tiny ACCO, DPU, DDP, eval, serve prefill and decode, captured), its
    train steps on the one-rank NCCL group: rules, dtypes, the census
    read from a profiled eager round's trace against the call sites,
    the in-place check across replays with ``memory_allocated()`` flat,
    and the overlap verdict on four profiled captured ACCO rounds of
    Llama-125M; (d) the memory
    sieve's state bytes against the rise of ``memory_allocated()`` across
    the state's construction, Llama-125M and the long cell."""
    import torch
    import torch.distributed as dist

    from acco_tpu_torch.analysis.__main__ import overlap_gate, program_gates
    from acco_tpu_torch.analysis.census import check_census
    from acco_tpu_torch.analysis.overlap import check_overlap
    from acco_tpu_torch.analysis.programs import build_all_tiny
    from acco_tpu_torch.analysis.trace import collectives_from_trace, nccl_kernels
    from acco_tpu_torch.telemetry.profile import load_events

    t0 = time.perf_counter()
    failed = []
    log(f" (a) rules, dtypes and the in-place watch over {len(STATE_GATES)} cells' states")
    for label, g in STATE_GATES.items():
        w = g["watch"]
        seen = ("" if w is None else f"; in place over {w['rounds']} rounds"
                + ("" if w["replays"] is None else f" ({w['replays']} replays)")
                + (f", MOVED {w['moved'][:3]}" if w["moved"] else ""))
        ok = g["rules"].ok and g["dtypes"].ok and (w is None or not w["moved"])
        log(f"  {label}: rules {g['rules'].summary()}; dtypes {g['dtypes'].summary()}{seen}")
        if not ok:
            failed.append(label)
        if w is not None and w["replays"] is not None and not label.endswith("-eager") \
                and not w["replays"]:
            failed.append(f"{label}: no replay watched")
    log(" (b) census and overlap on phase 7's profiled Llama-125M rounds (captured replays; "
        "the cell runs on no process group)")
    events = load_events(PROFILE_TRACES["llama-125M", False])
    calls = collectives_from_trace(events)
    census = check_census(calls, 0.0)
    overlap = check_overlap(events)
    log(f"  census: {census.summary()}; record_param_comms events {len(calls)}, NCCL kernels "
        f"seen {nccl_kernels(events)} -> {'ok' if census.ok else 'FAIL'}")
    log(f"  overlap: {overlap.summary()}")
    if not census.ok or not overlap.ok:
        failed.append("phase 7 trace")
    log(" (c) the program registry on the card, its train steps on the one-rank NCCL group")
    t1 = time.perf_counter()
    programs = build_all_tiny("cuda", sg.group)
    gates = program_gates(programs) + [overlap_gate(torch.device("cuda", 0))]
    groups = programs[0].meta["groups"]
    made = {id(g): g for g in (groups.comm_data, groups.comm_world) if g is not None
            and g is not sg.group and g is not dist.group.WORLD}
    del programs, groups
    gc.collect()  # the programs' graphs (a cycle through their bodies) before their group
    for g in made.values():
        dist.destroy_process_group(g)
    free_device_cache()
    for g in gates:
        for line in g.lines():
            log("  " + line)
        if not g.ok:
            failed.append(g.name)
    log(f"  the registry's gates in {time.perf_counter() - t1:.1f} s")
    log(f" (d) the memory sieve's state bytes against the rise of memory_allocated() across "
        f"init_state (bar: the rise within [sieve, sieve + {SIEVE_SLACK_BYTES} B]), on {smi}")
    for path, model_name in SIEVE_PATHS.items():
        predicted, rise = sieve_vs_measured(path, model_name)
        ok = predicted <= rise <= predicted + SIEVE_SLACK_BYTES
        log(f"  {path}: sieve {predicted:.0f} B ({predicted / 2**30:.3f} GiB), measured rise "
            f"{rise} B ({rise / 2**30:.3f} GiB), difference {rise - predicted:+.0f} B -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"sieve {path}")
    log(f"  phase 16 in {time.perf_counter() - t0:.1f} s on {smi}")
    if failed:
        raise AssertionError(f"phase 16: gates failed: {failed}")


def phase_6() -> None:
    """Small input: the kernel paths against the plain paths in float32,
    and the comm stream's ordering (correctness only: it runs beside the
    planted faults' builds and checks, in a one-rank group of its own)."""
    with one_rank_group() as sg:
        log(" the comm stream (tiny128, float32, L 128): ordering")
        stream_ordering()
        log(" tiny128 (K1), L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            ("attn_fwd", "attn_bwd_dkdv", "attn_bwd_dq"),
        )
        log(" gpt-neo-125M (K1 and K2), L 512")
        small_input_agreement(
            ["train=acco", "model=gptneo", "data=synthetic", "train.max_length=512",
             "train.batch_size=2"],
            ("attn_fwd", "attn_bwd_dkdv", "attn_bwd_dq", "banded_fwd", "banded_bwd_dq",
             "banded_bwd_dkdv"),
        )
        log(" tiny128, fused_loss=pallas (K3) vs the materialized CE, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            _K3_F32, runs=CE_RUNS, plain_silent=_K3,
        )
        log(" gpt-neo-125M, fused_loss=pallas (K1, K2 and K3) vs the materialized CE, L 512")
        small_input_agreement(
            ["train=acco", "model=gptneo", "data=synthetic", "train.max_length=512",
             "train.batch_size=2"],
            ("attn_fwd", "banded_fwd", *_K3_F32), runs=CE_RUNS, plain_silent=_K3,
        )
        log(" tiny128, use_pallas_attention=true (K5) vs the plain attention, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            _K5, runs=FLASH_RUNS,
        )
        log(" tiny128 on the one-rank ring (K4) vs the plain attention, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            ("blk_fwd_diag", "blk_fwd_full", "blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
            runs=RING_RUNS, sg=sg,
        )


def build_all() -> None:
    """The four kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from acco_tpu_torch.utils import cuda_build

    names = ("fused_attention", "banded_attention", "fused_ce", "flash_attention",
             "block_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for future in [pool.submit(cuda_build.build, n) for n in names]:
            future.result()
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for name in names:
        info = cuda_build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("    " + line.strip())


# The TPU kernel each Hopper kernel replaces (file:line of its pallas_call).
REPLACES = {
    "attn_fwd": "acco_tpu/ops/fused_attention.py:197",
    "attn_bwd_delta": "acco_tpu/ops/fused_attention.py:243",
    "attn_bwd_dkdv": "acco_tpu/ops/fused_attention.py:243",
    "attn_bwd_dq": "acco_tpu/ops/fused_attention.py:243",
    "banded_fwd": "acco_tpu/ops/banded_attention.py:240",
    "banded_bwd_dq": "acco_tpu/ops/banded_attention.py:279",
    "banded_bwd_dkdv": "acco_tpu/ops/banded_attention.py:314",
    "ce_fwd": "acco_tpu/ops/fused_ce.py:267",
    # one dp, one dH and one dW kernel serve both backward forms of the TPU
    # kernel: the split dH / dW calls and the fused call (:324); dp is the
    # `_dp_tile` (:160) that each of those calls computes
    "ce_bwd_dp": "acco_tpu/ops/fused_ce.py:324, acco_tpu/ops/fused_ce.py:356, "
                 "acco_tpu/ops/fused_ce.py:375",
    "ce_bwd_dh": "acco_tpu/ops/fused_ce.py:356, acco_tpu/ops/fused_ce.py:324",
    "ce_bwd_dw": "acco_tpu/ops/fused_ce.py:375, acco_tpu/ops/fused_ce.py:324",
    # JAX's bundled TPU flash kernel (jax.experimental.pallas.ops.tpu.
    # flash_attention), reached through the JAX package's flash path: the
    # forward, dK/dV and dQ pallas_calls and the backward's plain-jnp delta
    **dict.fromkeys(_K5, "acco_tpu/ops/attention.py:193"),
    # the ring's block: forward and VJP pallas_calls
    **dict.fromkeys(_K4[:3], "acco_tpu/ops/block_attention.py:200"),
    **dict.fromkeys(_K4[3:], "acco_tpu/ops/block_attention.py:250"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from acco_tpu_torch.utils.platform import default_allocator_settings
    except ImportError as exc:
        print(f"chip_smoke: the port is not in this checkout ({exc})", file=sys.stderr)
        return 2
    default_allocator_settings()  # as the entry point, before CUDA is initialised

    log("== 1 device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name}  count {count}  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}")

    log("== 2 build")
    build_all()
    # the planted faults, built and checked beside phase 3's parity checks
    # and phase 6
    faults = PlantedFaults()

    log("== 3 parity (bf16 unless named, kernel vs plain on the same inputs)")
    errs = {}
    from acco_tpu_torch.ops.attention import resolve_attention_impl

    impl = resolve_attention_impl("auto", K1_LLAMA3["L"], K1_LLAMA3["D"], "cuda")
    log(f" 'auto' at Llama-3-8B's head_dim 128, L {K1_LLAMA3['L']}, on the card: {impl!r}")
    if impl != "fused":  # JAX's resolver picks its fused kernel there on the TPU
        raise AssertionError(f"'auto' resolved to {impl!r} at head_dim 128, L "
                             f"{K1_LLAMA3['L']}, not 'fused'")
    for seed, (label, shape) in enumerate(K1_SHAPES):
        log(f" K1 {label}: {shape}")
        for kname, e in parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    for seed, (label, shape) in enumerate(BANDED_SHAPES, start=3):
        log(f" K2 {label}: {shape}")
        for kname, e in banded_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    log(" 'fused' GPT-Neo at head_dim 128: its local layer on K2")
    neo_d128_dispatch()
    for seed, (label, shape) in enumerate(CE_SHAPES, start=6):
        log(f" K3 {label}: {shape}")
        for kname, e in ce_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    log(f" K3's backward in 3 chunks of rows (dW summed in float32) at {CE_LLAMA}")
    for kname, e in ce_chunked_parity(CE_LLAMA, 11).items():
        errs[kname] = max(errs[kname], e)
    log(" head: float32 logits from bf16 operands")
    head_parity()
    for seed, (label, shape) in enumerate(FLASH_SHAPES, start=20):
        log(f" K5 {label}: {shape}")
        for kname, e in flash_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    for seed, (label, shape, variants) in enumerate(BLOCK_SHAPES, start=40):
        log(f" K4 {label}: {shape}")
        for kname, e in block_parity(shape, seed, variants).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    log("== 6 small input: the kernel path agrees with the plain path (float32), beside the "
        "planted faults")
    phase_6()
    log(" K3's bars (softmax-alone Llama-125M head; the chunked backward), K5's (small GQA "
        "shape with pads), K1's (rows with no allowed key, L 320), K2's (odd windows) and K4's "
        "(bf16 ties, small GQA hops, Lq != Lk) against planted faults")
    planted_faults(faults)

    log("== 4 timing (CUDA events)")
    log(f" K1 at the Llama flagship shape {FLAGSHIP}")
    times, backward = timing(FLAGSHIP)
    log(f" K1 at Llama-3-8B's width {K1_LLAMA3} (head_dim 128)")
    k1_d128, k1_d128_bwd = timing(K1_LLAMA3)
    for kname, r in k1_d128.items():
        times[kname]["llama3_width"] = r
    log(f" K2 at the GPT-Neo local shape {NEO_LOCAL}, scale 1.0")
    banded_times, banded_backward = banded_timing(NEO_LOCAL)
    log(f" K2 at GPT-Neo-2.7B's local shape {NEO_LARGE_LOCAL}, scale 1.0")
    banded_d128, banded_d128_bwd = banded_timing(NEO_LARGE_LOCAL)
    for kname, r in banded_times.items():
        times[kname] = {**r, "d128": banded_d128[kname]}
    log(f" K3 at the main path's head {CE_MAIN}")
    ce_times, ce_backward, ce_errs = ce_timing(CE_MAIN, BATCH, SEQ)
    log(f" K3 at the long-context paths' head {CE_LONG}")
    long_times, long_backward, long_errs = ce_timing(CE_LONG, 1, CE_LONG["seq"])
    for kname, r in ce_times.items():
        times[kname] = {**r, "long_head": long_times[kname]}
    for kname in ce_errs:
        errs[kname] = max(errs[kname], ce_errs[kname], long_errs[kname])
    log(f" K5 at the Llama flagship shape {FLASH_FLAGSHIP}, beside K1 (above)")
    flash_flagship, flash_flagship_bwd = flash_timing(FLASH_FLAGSHIP)
    for k5, k1 in zip(_K5, _K1):
        log(f"  {k5:15s} K5 {flash_flagship[k5]['ms']:.4f} ms  K1 {times[k1]['ms']:.4f} ms")
    log(f"  backward total  K5 {flash_flagship_bwd['ms']:.4f} ms  K1 {backward['ms']:.4f} ms")
    log(f" K5 at the long-context main path's shape {FLASH_LLAMA3}")
    flash_times, flash_backward = flash_timing(FLASH_LLAMA3)
    for kname, r in flash_times.items():
        times[kname] = {**r, "flagship": flash_flagship[kname]}
    # K4: the JSON entry of each kernel is its time at the Llama ring
    # path's shape (b) (the backward kernels: on the full block), or for
    # the positional forward at GPT-Neo's (c) with window 256; every
    # shape and variant measured stands beside it under "by_shape"
    block_times = {}
    for tag, shape, variants in (("a", BLOCK_350M, ("full", "diag")),
                                 ("b", BLOCK_LLAMA3, ("full", "diag")),
                                 ("c", BLOCK_NEO, (f"hop sp2 w{NEO_WINDOW}",))):
        log(f" K4 at ({tag}) {shape}")
        for key, r in block_timing(shape, variants, 50).items():
            block_times[f"{key} ({tag})"] = r
    pos = f"hop sp2 w{NEO_WINDOW}"
    for kname, key, variants in (
        ("blk_fwd_full", "blk_fwd/full (b)", ("full",)),
        ("blk_fwd_diag", "blk_fwd/diag (b)", ("diag",)),
        ("blk_fwd_pos", f"blk_fwd/{pos} (c)", (pos,)),
        ("blk_bwd_rowc", "blk_bwd_rowc/full (b)", ("full", "diag", pos)),
        ("blk_bwd_dkdv", "blk_bwd_dkdv/full (b)", ("full", "diag", pos)),
        ("blk_bwd_dq", "blk_bwd_dq/full (b)", ("full", "diag", pos)),
    ):
        family = key.split("/")[0]
        times[kname] = {**block_times[key], "by_shape": {
            k: {x: r[x] for x in ("ms", "plain_ms", "bound_ms", "sdpa_ms", "sdpa_bwd_ms") if x in r}
            for k, r in block_times.items()
            if k.split("/")[0] == family and k.split("/")[1].rsplit(" (", 1)[0] in variants}}

    launches, round_ms, peaks, summaries = {}, {}, {}, {}
    for step, path in enumerate(MAIN_PATHS, start=1):
        log(f"== 5.{step} main path {path}: {' '.join(main_args(path))}")
        launches[path], round_ms[path], peaks[path], summaries[path] = main_path(path)
    # the ring paths: context parallelism on a one-rank NCCL sequence
    # group, made only now (the paths above run with no process group)
    with one_rank_group() as sg:
        for step, path in enumerate(RING_PATHS, start=len(MAIN_PATHS) + 1):
            base = RING_PATHS[path]["base"]
            log(f"== 5.{step} ring path {path}: {' '.join(main_args(base))}, the model on the ring, "
                f"a one-rank NCCL sequence group handed in")
            launches[path], round_ms[path], peaks[path], summaries[path] = main_path(path, sg)
            ring_loss_vs(summaries[path], summaries[base], base)
        log(" gpt-neo-125M: one forward and backward, the windowed ring (K4) against the non-CP "
            "path (K1 + K2), K3 on both")
        neo_ring_step_agreement(sg)
        # the dp paths: the same one-rank NCCL group, handed in as the dp group
        for step, path in enumerate(DP_PATHS, start=len(MAIN_PATHS) + len(RING_PATHS) + 1):
            log(f"== 5.{step} dp path {path}: {' '.join(main_args(path))}, a one-rank NCCL dp "
                f"group handed in")
            launches[path], round_ms[path], peaks[path], summaries[path] = main_path(
                path, group=sg.group)
            dp_losses_vs(path, summaries[path], summaries["llama-125M"])
        log(f"  peak memory by path: { {p: f'{b / 2**30:.2f} GiB' for p, b in peaks.items()} }")
        log("== 7 where the device time goes (profiled reruns of the main paths)")
        profiles = {}
        for model in PROFILED_PATHS:
            profiles[model] = profile_main_path(model, round_ms[model], sg=sg, group=sg.group)
            # the comm branch on the current stream: the flagship only (the
            # other cells' reruns cut for time)
            if model not in ONE_STREAM_PATHS:
                continue
            one = stream_variant_ms(model, sg, sg.group)
            profiles[model].update(round_ms=round_ms[model], one_stream_round_ms=one)
            log(f"  {model}: median round ms, comm branch on its own stream (phase 5) "
                f"{round_ms[model]:.2f}, on the current stream {one:.2f}")
        log("  comm side, overlap share and idle share by path: "
            f"{ {p: {k: round(v, 4) for k, v in r.items()} for p, r in profiles.items()} }")

        log("== 8 resume, eval and perplexity (Llama-125M, full width)")
        launches["llama-125M-fusedce-eval"], cadence = resume_phase(smi, round_ms)
        # what phase 11 compares against, kept: phase 9 frees the runs
        cadence_losses = {p: (c[0], [r["loss"] for r in c[1]["round_log"]])
                          for p, c in cadence.items()}

        log("== 9 the input pipeline, remat, finetuning from a local HF checkpoint")
        launches.update(phase_9(smi, cadence, round_ms, peaks))

        log("== 10 a run that survives: the overlapped save, SIGTERM, drills, telemetry")
        drills = {}
        launches.update(phase_10(smi, profiles, drills))

        log("== 11 the rounds captured as CUDA graphs and replayed, against eager rounds")
        launches.update(phase_11(smi, sg, round_ms, summaries, launches, profiles,
                                 cadence_losses, drills))

        log("== 12 serving: the Llama-3-8B replica, parity, planted faults, HTTP")
        phase_12(smi)

        log("== 13 tensor parallelism: K3's vocab-parallel wrapper, the tp paths")
        tp_launches, vp_entry = phase_13(smi, sg, summaries, round_ms, peaks)
        launches.update(tp_launches)

        log("== 14 pipeline parallelism: GPT-Neo-2.7B's stage and the long-context cell at pp 1")
        pp_launches = phase_14(smi, sg.group, summaries, round_ms, peaks)
        launches.update(pp_launches)
        vp_entry["launches_by_path"].update({p: n["vp_ce"] for p, n in pp_launches.items()})

        log("== 15 the compositions: the 8B preset's stage through pp x tp, the long ring cell "
            "through the four axes, GPT-Neo's ring through tp x sp and pp x sp")
        composed = phase_15(smi, summaries, round_ms, peaks)
        launches.update(composed)
        vp_entry["launches_by_path"].update({p: n["vp_ce"] for p, n in composed.items()})

        log("== 16 the static gates: rules, dtypes, in-place over every cell; census and "
            "overlap on phase 7's trace; the program registry; the memory sieve")
        phase_16(smi, sg)

        # launches: each kernel's count on its own slice's main path (K1: the
        # Llama path, K2: the GPT-Neo path, K3: the fused-CE path, K5: the
        # long-context path), and on every path. K5's times are at the
        # long-context path's shape, with the flagship shape's beside them.
        kernels = [
            {
                "name": kname,
                "route": "cuda",
                "source": "acco_tpu_torch/csrc/" + SOURCE[kname],
                "replaces": REPLACES[kname],
                "launches": launches[OWN_PATH[kname]][kname],
                "launches_by_path": {m: launches[m][kname] for m in launches},
                "max_abs_err": errs[kname],
                **times[kname],
            }
            for kname in times
        ] + [vp_entry]
        log(f"K1 backward total (delta + dK/dV + dQ): {json.dumps(backward)}; at Llama-3-8B's "
            f"width: {json.dumps(k1_d128_bwd)}")
        log(f"K2 backward total (delta + dQ + dK/dV): {json.dumps(banded_backward)}; at D 128: "
            f"{json.dumps(banded_d128_bwd)}")
        log(f"K3 backward total (dp + dH + dW) and the whole loss, Llama-125M head: "
            f"{json.dumps(ce_backward)}; long-context head: {json.dumps(long_backward)}")
        log(f"K5 backward total (delta + dK/dV + dQ), L 8192: {json.dumps(flash_backward)}; "
            f"flagship: {json.dumps(flash_flagship_bwd)}")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": count}}), flush=True)
        return 0


if __name__ == "__main__":
    sys.exit(main())
