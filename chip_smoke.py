#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its numbers on lines of its own:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit; then the CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together, the tensor-core sources on the
   shared ``hopper.cuh``) and ptxas' register, spill and performance-warning
   report shown;
2. kernels against their plain PyTorch versions at the qwen2-7b shapes
   (FFN up-projection (4096, 3584) @ (3584, 18944), causal prefill
   attention q (2, 2048, 28, 128), k/v (2, 4, 2048, 128), and decode
   attention q (8, 28, 128) against a KV cache (8, 4, 32768, 128) with a
   random valid prefix per row, all bf16), at recurrentgemma-2b's served MQA
   decode (q (8, 10, 256), k/v (8, 1, 2048, 256) bf16, valid from the ring
   buffer's positions after 2048 + 64 tokens) and at the serving prefill's
   scan shapes (RG-LRU a, b (8, 2048, 2560) fp32 of recurrentgemma-2b;
   RWKV-6 r, k, v (8, 2048, 64, 64) bf16 with fp32 lw, u, s0 of rwkv6-7b),
   at default and non-default knobs, plus a small fp32 case each, the RWKV
   strong-decay case (lw = -14, fp32 and bf16) and a decode row with no
   valid slot; the matmul and flash attention at their default tile and one
   more tile of the tensor-core (``wgmma``) design and at one tile of the
   SIMT design, each line naming the design that ran; decode with its split
   count and grid, held against the plain version at that split count; the
   RWKV scan naming its design (the bf16 serving shape must run the
   sub-chunked tensor-core design ``tc``, fp32 the ``per_token`` one), and
   the per-token design once through its C entry point; the segmented lru
   scan with its segment count, against the exact scan and against its own
   segmented arithmetic (``lru_scan_segmented_plain``); then the scans'
   backward kernels at the trained shapes (lru a, b, g (4, 256, 2560) fp32
   at ``rec_chunk`` 8, one fused kernel split by ``linear_scan.lru_bwd_tiling``;
   rwkv r, k, v, gy (1, 2048, 64, 64) bf16, its state rows split over
   ``linear_scan.rwkv_bwd_slices`` blocks a cluster), with the final-state
   cotangents nonzero, against their plain versions (``lru_scan_bwd_plain``,
   ``rwkv_scan_bwd_plain``; each output by ||kernel - plain|| / ||plain||,
   ``BWD_REL``), the lru one also against its own arithmetic
   (``lru_scan_bwd_segmented_plain``, ``LRU_BWD_SEG_REL``), two calls of each
   bit-identical, planted faults that the same limit must reject (the lru
   da formed with h_t in place of h_{t-1}; the rwkv gradient's dk or dv
   without its u term), and one call of each under ``torch.profiler`` at two
   sequence lengths: the same kernel count, one kernel for the lru
   backward; then flash attention's backward kernel at the
   trained shapes (``FA_BWD_CASES``: seamless-m4t-large-v2's encoder layer
   q (3, 4096, 16, 64) non-causal and qwen2-7b's layer q (1, 2048, 28, 128),
   k/v 4 heads, causal, both bf16 on the tensor-core ``wgmma`` design, whose
   dK/dV pass splits qwen2-7b's 7 query heads a group over blocks
   (``flash_attention.bwd_head_splits``); (1, 512, 8, 64) fp32 on the
   CUDA-core design; q, k, v and dO strided views) against
   ``flash_attention_bwd_plain`` on the forward kernel's o and lse (the lse
   held against the plain forward's), two calls bit-identical, a planted
   fault (dq and dk without the -D term) the same limit must reject, and
   one call under ``torch.profiler`` at 2048 and 512 tokens: the same
   kernel count; then AdamW's multi-tensor kernel (``kernels/adamw.py``)
   against ``adamw_plain`` on a ragged tree (lengths 1 to 65541, one leaf
   4 bytes past a 16-byte boundary), fp32 and bf16 state, 3 steps with the
   clip engaged: fp32 within 1e-6 of each leaf's scale, bf16 within a bf16
   step, the global norm to 1e-6, three launches an update;
3. the PATSMA tuning loop: ``tune_call`` on the five calls with the default
   CSA budget, committing records to ``DIR/tune.json``, and once more on
   the decode call with ``strategy="csa+nm"`` into ``DIR/tune_csa_nm.json``;
4. replay: ``autotuned`` on the same DB is an exact hit (one launch, output
   bit-equal to the kernel at the stored knobs, which is launched for the
   comparison only after the main path's counts are read);
5. the pretune CLI (``--smoke``) twice in-process; the second run makes only
   exact hits; then once with ``--strategy csa+nm --cost analytic
   --obs-dir``, and the host-side ``python -m repro_torch.tune`` commands
   (``db list``, ``db diff``, ``report`` on that run) in subprocesses;
6. the adaptive route: a fresh ``kernel_router`` on a fresh DB serves ~200
   ``routed("decode_attention", ...)`` calls at the qwen2-7b decode shape
   with epsilon 0.1 and a short stream of each other kernel; every output
   is held (after the counts are read) against the kernel at the knobs its
   call was served with, and a second router on the same DB must exact-hit
   the committed decode record and explore nothing;
7. times with CUDA events: each kernel at default and tuned knobs (the
   scans also at the serving path's ``chunk=4``), its plain version, one
   library call for the same function where one exists (a yardstick the
   port never calls; no single PyTorch call computes either scan), and the
   analytic roofline bound; the default and tuned matmul and flash calls
   must run the ``wgmma`` design; decode's split count, grid, share of the
   bytes bound and ratio to SDPA at default and tuned knobs; the RWKV
   tensor-core design at ``chunk=4`` and the tuned chunk beside the
   per-token design on the same inputs, with its share of the bytes bound;
   the lru scan at default, tuned and ``chunk=4`` with its segment count
   and share of the bytes bound; and flash attention at the shape of
   seamless-m4t-large-v2's encoder (q (8, 4096, 16, 64), k/v (8, 16, 4096,
   64) bf16, non-causal) against its plain version, at the default tiles
   and tuned (its own DB), with SDPA's time and the bound; the scans'
   backward kernels at phase 2's shapes beside their plain versions, the
   eager per-token oracle (autograd through ``ref.*_scan_ref``) and their
   fp32 bounds; flash attention's backward kernel at phase 2's two bf16
   shapes beside its plain version, the eager oracle it replaced (autograd
   through ``ref.flash_attention_ref``), SDPA's backward (KV heads
   expanded) and its bound (five products at the bf16 rate); AdamW's
   kernel at seamless-m4t-large-v2's 726 leaves in fp32 (1.63 B parameters,
   26.1 GB of p, g, m and v) beside its plain version (the eager per-leaf
   loop), ``torch._fused_adamw_`` (no clip) and its bound (32 bytes a
   parameter);
8. serving recurrentgemma-2b at full width and depth through
   ``repro_torch.launch.serve`` (batch 8, prompt 2048, 64 new tokens, random
   weights from seed 0) twice on one DB: the first run tunes the decode
   depth online and commits it, the second must be a DB hit.  Every prefill
   must launch ``lru_scan`` 18 times (one per RG-LRU layer).  Then the
   served model's final prefill hidden state on the kernel path is held
   against the plain path (``attn_impl="xla"``) in fp32 arithmetic, and the
   scan kernel against its plain version on the last layer's scan inputs
   as served (bf16 r, k, v for rwkv).  Decode runs as CUDA graphs of the
   tuned depth, every capture on the router's pool (none in-band).  Then
   the decode profile: one eager step's wall time, device-busy time and
   kernel launches (``torch.profiler``), the same for a replay of the
   8-step graph, and the first 16 greedy tokens of the eager loop against
   the 1-step and the 8-step graphs (equal tokens; logits within
   ``LOGITS_TOL``);
9. the same for rwkv6-7b at full width and depth (32 ``rwkv_scan`` launches
   per prefill, every one of the tensor-core design);
10. training recurrentgemma-2b at full width and depth through ``TrainJob``
   (weights from seed 0, fp32 masters and AdamW state on the card, the
   kernels with ``rec_chunk`` 8, batch 4 x 256 tokens, lr 1e-3 with no
   warmup): run 1 tunes the
   microbatch count over {1, 2, 4} (``DIR/train.json``) and goes on 2 steps
   past the tuning (cap 40), printing the loss per step (finite and
   falling), step wall times, tokens/s, peak memory and the launches per
   step (``lru_scan`` 18 per microbatch, the forward; ``lru_scan_bwd`` 18,
   the backward's one kernel each); run 2 on the same DB must be an exact
   hit (4 steps).  Then, on one model and one batch with no update, the
   kernel path's loss and global gradient norm against the plain path's
   (1e-3 / 1e-2 relative), with the lru backward timed per call beside the
   per-token oracle backward it replaced; then a tiny job with async
   checkpoints every 2 steps, each of which must restore the parameters and
   optimizer state ``on_step`` saw at its step, bit for bit;
11. qwen2-7b at full width with 2 layers through ``make_train_step``, batch 1
   x 2048 tokens: one step and a second on the kernel path (2 flash
   launches a step, all of the ``wgmma`` design, under autograd, and 2
   backward launches of the ``wgmma`` design) and on the plain path from the
   same weights; loss and gradient norm before the update (1e-3 / 1e-2
   relative), step wall times, tokens/s, peak memory and the flash
   backward's device ms a step (CUDA events around each call);
12. serving seamless-m4t-large-v2 at full width and depth (24 encoder and 24
   decoder layers, frames (8, 4096, 1024), batch 8, prompt 2048, 64 new
   tokens) twice on one DB (the second a DB hit): every prefill launches
   the flash kernel 24 times, all non-causal and of the ``wgmma`` design;
   the kernel on the last encoder layer's served q, k, v against its plain
   version; the decode profile and graph-vs-eager tokens as in phase 8; the
   final prefill hidden state on the kernel path against the plain path in
   fp32 arithmetic (``HIDDEN_TOL``);
13. moonshot-v1-16b-a3b (MoE, 64 experts, top-6) at full width and depth,
   the same serve arguments, twice on one DB: prefill takes the capacity branch (C = 1920,
   the drops counted per layer), a decode step is drop-free (C = T·K =
   48), graph tokens equal eager tokens;
14. qwen2-7b at full width and depth, the same serve arguments, twice on
   one DB (no kernel on this path), graph decode against eager; then one
   eager decode step under ``torch.profiler`` with shapes recorded: the
   scores come from ``aten::bmm`` in its fp32-output overload, one per
   attention layer, and nothing copies or converts a tensor of the K
   cache's shape;
15. llama-3.2-vision-11b at full width and depth (40 layers, 8 with cross
   attention over ``ctx_embeds`` (8, 6400, 4096)), the same serve arguments,
   twice on one DB, graph decode against eager, the peak memory; then
   arctic-480b ``--tiny`` (batch 8, prompt 256; it fits no card): prefill
   and graph decode against eager;
16. the device-pinned fleet: ``local_device_pool(4, cache=exec_cache())``
   (every slot on the one card), then a ``ShardedPortfolio`` race (two CSA
   members, a random search and a Nelder-Mead) over the matmul kernel's
   tiles at the qwen2-7b FFN shape in bf16, each member's measurements
   pinned to its slot's card by ``device_bound_measure`` and checked there,
   in the worker thread; the race's wall time, the members' bests and the
   survivors, and the winner against its plain version (phase 2's limit);
17. on a one-rank NCCL group and a ``("data",)`` mesh: ``int8_psum``,
   ``topk_psum`` and ``chunked_psum`` on a qwen2-7b FFN gradient (3584,
   18944) fp32 held to their one-rank meaning (int8 within scale/2, plus two fp32 ulps, of the
   input; the sparse part plus the residual equal to the input; chunked
   bit-equal to the all-reduce) and timed; ``make_compressed_dp_step``
   4 steps with each of ``exact``, ``int8``, ``topk`` (k_ratio 0.01) and
   ``chunked`` (64 MB) on phase 11's qwen2-7b cut (2 layers, 1 x 2048, the
   flash kernel), ``exact`` holding ``make_train_step``'s losses to 1e-5,
   with losses, step ms, peak memory and wire bytes per method; and
   ``gpipe_apply`` with the one stage one card has, against its
   sequential oracle;
18. ``torchrun --standalone --nproc_per_node 1`` running the training
   launcher's ``--distributed`` path (NCCL) on recurrentgemma-2b at full
   width and depth with phase 10's arguments and tuning DB (an exact hit),
   3 steps: 18 ``lru_scan`` and 18 ``lru_scan_bwd`` launches a step per
   microbatch, the first loss bit-equal
   to phase 10's run 2; then ``pretune --launch --cost
   analytic --smoke`` twice on one DB (3 searched, then 3 exact hits),
   host arithmetic on the H100 data sheet that launches no kernel;
19. the launch dry run (``repro_torch.launch.dryrun``: DTensors on the
   meta device over fake process groups, host work that launches no
   kernel, in subprocesses started with phase 16).  Its calibration: phase
   17's ``make_train_step`` cell (qwen2-7b, 2 layers, 1 x 2048, the flash
   kernel) and the same cell measured here under ``remat="full"`` (4 steps:
   the flash kernel runs in the forward pass and again in the recompute),
   each against the dry run's model of it at world 1 on the kernel's cost
   surrogate (``attn_impl="flashcost"``, its FLOPs added back): the
   modelled compute, memory and bound ms on the H100 data sheet, measured
   ms / bound, the argument bytes modelled against the card's parameters +
   AdamW state + batch (equal to the byte), modelled peak / measured peak.
   Then the dry run's ``--all`` on the (16, 16) fake mesh (40 cells: 32
   ok, 8 skipped; among them ``launch_cases(smoke=True)``, qwen2-7b
   ``decode_32k`` and rwkv6-7b ``long_500k``) and qwen2-7b ``decode_32k``
   on the (2, 16, 16) ``--multi-pod`` mesh, each line with its
   ``elapsed_s``;
   ``pretune --launch --cost runtime --smoke --devices 8`` twice (3
   searched, then 3 exact hits; each committed best no worse than its
   default); ``hillclimb --arch qwen2_7b --shape train_4k --budget 6``;
20. starcoder2-15b at full width and depth (LayerNorm, the GELU MLP and
   the q/k/v biases, checked on the served weights), the same serve
   arguments, twice on one DB, graph decode against eager, the peak;
21. the plain attention (``_sdpa``) in the reference's product form (bf16
   q and k multiplied with fp32 output) against an inline copy of the
   upcast form it replaced, on the same tensors at qwen2-7b's prefill and
   decode step, seamless's cross attention and moonshot's prefill: CUDA-event
   ms of each (in turns), the peak bytes each allocates, outputs within
   ``SDPA_TOL``;
22. training seamless-m4t-large-v2 at full width and depth through
   ``TrainJob`` (frames of 4096, ``SEAMLESS_TRAIN``: the largest batch of
   512 decoder tokens under 80 GB, lr 1e-3 with no warmup, 6 steps): the
   loss per step (finite, the last below the first), step ms, tokens/s, the
   peak, the flash launches per step (the 24 encoder layers non-causal and
   the 24 decoder self-attentions causal, all of the ``wgmma`` design, the
   count taken from the config), as many backward launches of the ``wgmma``
   design and their device ms a step; the same job at batch 3 for 2 steps,
   for its peak; then the kernel path against the plain path on one
   sequence, no update (loss 1e-3, gradient norm 1e-2 relative);
23. moonshot-v1-16b-a3b at full width with 2 of its 48 layers through
   ``make_train_step``, batch 1 x 2048, 4 steps: the same checks and prints,
   the flash kernel and its backward causal, and the MoE dispatch's
   capacity branch with its drops per layer;
24. training rwkv6-7b at full width with 17 of its 32 layers (the most
   whose peak stays under 80 GB) through ``make_train_step``, batch 1 x
   2048, ``rec_chunk`` 8, 3 steps: loss and grad norm per step, step ms,
   tokens/s, the peak, 17 ``rwkv_scan`` (tensor-core design) and 17
   ``rwkv_scan_bwd`` launches a step; then on one batch, no update: each
   layer's ``rwkv_scan`` inputs captured on the kernel path, the
   tensor-core kernel's y on them against the exact per-token scan in fp32
   (``RWKV_FWD_REL``) and against the sub-chunked plain version (``TOL``);
   the kernel path against the plain path (``wkv_chunked``) in bf16 beside
   the kernel path with the exact per-token forward, with the rwkv
   backward's ms a call (printed: at 17 random bf16 layers two exact
   forwards already part by tens of per cent in grad norm); the kernel
   path's forward with its backward through the kernel against through
   ``rwkv_scan_bwd_plain`` (the same loss, grad norm 1e-2 relative); in
   fp32 arithmetic the kernel path against the plain path (loss 1e-3, grad
   norm 1e-2 relative); and ``RWKV_AGREE_LAYERS`` layers trained the same
   way, kernel path against plain path in bf16 (loss 1e-3, grad norm 1e-2
   relative).

Phases 10-11 with 22-24, 12-15 with 20-21, and 16-17 with 19 run after
phase 7, before serving, in three child processes (``--train-phases``,
``--family-phases``, ``--parallel-phases``), one after the other, each with
the card to itself:
this process keeps what its caching allocator holds until it exits.  Each
child reports its launch counts on its last line; phase 18's torchrun rank
(``--distributed-train``) does the same.

Phases 3-5 (the tuning loop), phase 6 (the route), phases 8-9, 12-15 and
20 (serving), phases 10-11 and 22-24 (training) and phases 16-19 (the
parallel layer and the launch dry run's calibration) are the main paths:
the kernels' launch counters are set to 0 just before each path and read
just after, and every kernel must have launched on one of them.  Phases
10, 18, 22, 23 and 24 must run one AdamW update a step through the kernel:
three launches over every leaf of the model (``adamw_updates``).
The line before the last two is a JSON object with one entry per kernel;
then ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, and so
does a run without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: atol = rtol per kernel and dtype for kernel vs plain version: the same
#: fp32 arithmetic summed in another order (fp32), plus output rounding
#: (bf16).  The matmul's bf16 outputs are O(1); causal attention over 2048
#: keys averages most rows down to a few hundredths, so its bf16 limit sits
#: just above one bf16 rounding step at those magnitudes.
TOL = {"matmul": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_attention": {"float32": 1e-5, "bfloat16": 5e-3},
       # decode: fp32 m/l/acc and p in both, summed in another order; bf16
       # outputs reach |o| ~ 3 on short valid prefixes, where one bf16
       # rounding step is 1.6e-2 = atol + rtol * |o| at 5e-3
       "decode_attention": {"float32": 1e-5, "bfloat16": 5e-3},
       # the scans: the same fp32 recurrence (the lru kernel fuses the
       # multiply-add); rwkv's bf16 y rounds an fp32 sum of 64 products, at
       # the JAX package's bf16 limit for this scan
       "lru_scan": {"float32": 1e-5, "bfloat16": 3e-2},
       "rwkv_scan": {"float32": 1e-5, "bfloat16": 5e-2}}
#: the scans' backward, each output against its plain version by
#: ||kernel - plain|| / ||plain||, by the output's dtype.  The gradients are
#: sums of products that cancel and are heavy-tailed, so an element-wise
#: limit tied to the largest |plain| would pass a missing term; a bf16
#: output rounds each element once (about 2e-3 of the norm), an fp32 one
#: sums the same fp32 products in another order
BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
#: the lru backward kernel (fp32 here) against its own arithmetic in plain
#: PyTorch (``lru_scan_bwd_segmented_plain`` at the kernel's tiling),
#: norm-wise: the same association, the kernel's fused multiply-adds against
#: the plain version's multiply and add (6e-8 to 2e-7 measured on an H100)
LRU_BWD_SEG_REL = 1e-6
#: atol = rtol for the served model's final prefill hidden state, kernel
#: path against plain path, both run in fp32 arithmetic on the served
#: (bf16-stored) weights.  In bf16 the two paths round the scans' outputs
#: differently and 26-32 random layers spread the flips (printed, not held
#: end to end; the served bf16 scan is held at TOL on the model's own inputs).
HIDDEN_TOL = 1e-3
#: decode as a CUDA graph against the eager loop: the same kernels on the same
#: inputs, so the tokens must be equal and the bf16 logits agree to within the
#: JAX tests' bf16 limit, 3e-2 of the largest |logit|
LOGITS_TOL = 3e-2
DECODE_TOKENS = 16

MM_SHAPE = (4096, 3584, 18944)  # tokens (batch 2 x 2048), d_model, d_ff
FA_SHAPE = (2, 2048, 28, 4, 128)  # batch, seq, query heads, KV heads, head dim
DA_SHAPE = (8, 28, 4, 32768, 128)  # qwen2-7b decode: batch, heads, KV heads, cache, head dim
RG_DA_SHAPE = (8, 10, 1, 2048, 256)  # recurrentgemma-2b MQA decode over its 2048-slot ring
RING_TOKENS = 2048 + 64  # prompt + generated tokens before the ring's decode step
ROUTE_CALLS = {"decode_attention": 200, "matmul": 20, "flash_attention": 20, "lru_scan": 20,
               "rwkv_scan": 20}
LRU_SHAPE = (8, 2048, 2560)  # recurrentgemma-2b prefill: batch, prompt, RG-LRU width
RWKV_SHAPE = (8, 2048, 64, 64)  # rwkv6-7b prefill: batch, prompt, heads, head dim
SERVE = (("recurrentgemma_2b", "lru_scan", 18), ("rwkv6_7b", "rwkv_scan", 32))
SERVE_ARGS = ["--batch", "8", "--prompt-len", "2048", "--gen", "64", "--epsilon", "0.5"]
SEAMLESS, MOONSHOT, QWEN = "seamless_m4t_large_v2", "moonshot_v1_16b_a3b", "qwen2_7b"
LLAMA_V, STARCODER = "llama_3_2_vision_11b", "starcoder2_15b"
# training (phase 10): recurrentgemma-2b at full width and depth; the batch is
# what one card holds beside its fp32 weights, gradients and AdamW state
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_CAP = "recurrentgemma_2b", 4, 256, 40
RG_LRU_LAYERS = 18  # lru_scan launches per forward pass
# phase 11: qwen2-7b at full width, 2 layers, one sequence of 2048 tokens
QWEN_LAYERS, QWEN_SEQ = 2, 2048
# phase 22: seamless-m4t-large-v2 trained at full width and depth through
# TrainJob, frames of 4096: the largest (batch, decoder tokens) under 80 GB.
# With the flash backward kernel batch 4 still runs out of memory in the
# backward (``scripts/probe_flash_train.py --seamless-batches 3 4``)
SEAMLESS_TRAIN, SEAMLESS_TRAIN_STEPS = (3, 512), 6
# phase 23: moonshot-v1-16b-a3b at full width with 2 of its 48 layers
MOONSHOT_TRAIN_LAYERS, MOONSHOT_TRAIN_STEPS = 2, 4
TRAIN_TIMEOUT_S = 900  # the training child process
TRAIN_RESULT = "train launches: "  # the child's last line: its launch counts as JSON
# phases 12-15: the encoder-decoder, VLM and MoE families served, in a child
# process of their own (moonshot-v1-16b-a3b needs most of the card)
SEAMLESS_ENC_LAYERS = 24  # non-causal flash launches per seamless prefill
ENC_FA_SHAPE = (8, 4096, 16, 16, 64)  # seamless encoder: batch, frames, heads, KV heads, head dim
FAMILY_TINY = ("arctic_480b",)  # served --tiny on the card: it fits no card
# phase 21: the plain attention (``_sdpa``) in the reference's product form
# against the upcast form: (label, q (B, Sq, H, hd), KV heads, KV length, causal)
SDPA_FORMS = (("qwen2-7b prefill", (8, 2048, 28, 128), 4, 2048, True),
              ("qwen2-7b decode step", (8, 1, 28, 128), 4, 2048 + 64, False),
              ("seamless cross", (8, 2048, 16, 64), 16, 4096, False),
              ("moonshot prefill", (8, 2048, 16, 128), 16, 2048, True))
SDPA_REPS = 3  # timed calls of each form: (a, b, b, a) x SDPA_REPS
#: the two forms' bf16 outputs against each other: the fp32 scores of the
#: two products sum in other orders, so a probability can round to the
#: neighbouring bf16 value, and so can the output
SDPA_TOL = 1e-2
TINY_SERVE_ARGS = ["--tiny", "--batch", "8", "--prompt-len", "256", "--gen", "64", "--epsilon", "0.5"]
FAMILY_TIMEOUT_S = 1000
FAMILY_RESULT = "family launches: "  # the child's last line: its launch counts as JSON
# phases 16-18: the parallel layer, in a child process of its own (16-17)
# and under torchrun (18)
FLEET_SLOTS = 4  # local_device_pool slots, round-robin over the cards
DP_STEPS = 4  # make_compressed_dp_step steps per method (phase 11's qwen2-7b cut)
DP_CHUNK_BYTES = 64 << 20  # chunked_psum's chunk
PARALLEL_TIMEOUT_S = 900
PARALLEL_RESULT = "parallel launches: "  # the child's last line: its launch counts as JSON
DIST_STEPS, DIST_TIMEOUT_S = 3, 400  # launch.train --distributed on recurrentgemma-2b
DIST_RESULT = "distributed launches: "  # the torchrun rank's last line
# phase 19: the launch dry run.  Its counting is host work on meta tensors
# over fake process groups, so it runs in subprocesses started with phase 16
# (the child holds a one-rank NCCL group in phase 17); the card measures the
# calibration cell, phase 17's qwen2-7b cut
DRYRUN_TIMEOUT_S = 600
DRYRUN_SHAPE = ("train_2048x1", "train", QWEN_SEQ, 1)  # ShapeSpec of phase 17's cut
# the scans' backward kernels: phase 2's shapes are the trained ones
LRU_BWD_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 2560)  # recurrentgemma-2b in phase 10 (fp32)
TRAIN_REC_CHUNK = 8  # the training launcher's rec_chunk (TrainJob's ExecConfig)
# phase 24: rwkv6-7b at full width, one sequence of 2048 tokens, depth cut
# to the most layers whose fp32 weights, gradients and AdamW state (16 bytes
# a parameter: 3.5 GB a layer, 8.6 GB for the embedding and head) and
# activations stay under 80 GB
RWKV_TRAIN, RWKV_TRAIN_LAYERS, RWKV_TRAIN_STEPS = (1, 2048), 17, 3
#: the tensor-core forward's y on each trained layer's inputs against the
#: exact scan in fp32, ||y - exact|| / ||exact||: y rounds once to bf16
#: (1.66e-3 of the norm for the exact values rounded) after TF32 operands
#: (under 2.2e-4 before the rounding)
RWKV_FWD_REL = 2.5e-3
#: the depth at which phase 24 holds the bf16 kernel and plain paths, and
#: the backward kernel and its plain version, against each other: at 17
#: random layers the bf16 gradient norm parts by tens of per cent between
#: any two forwards that differ in a few roundings, and by per cents
#: between the two backwards as the trained weights move by a rounding
RWKV_AGREE_LAYERS = 4
RWKV_BWD_SHAPE = (1, 2048, 64, 64)  # rwkv6-7b in phase 24: batch, tokens, heads, head dim (bf16)
BWD_SHAPES_T = {"lru_scan_bwd": 2048, "rwkv_scan_bwd": 512,  # the other T the profiler counts at
                "flash_attention_bwd": 512}
#: flash attention's backward at the trained shapes (label, (batch, seq,
#: query heads, KV heads, head dim), dtype name, causal): seamless's encoder
#: layer (phase 22's batch, 24 calls a step), qwen2-7b's layer (phase 11,
#: GQA 28/4 at head dim 128) and one fp32 case (the CUDA-core design)
FA_BWD_CASES = (("seamless encoder", (3, 4096, 16, 16, 64), "bfloat16", False),
                ("qwen2-7b layer", (1, 2048, 28, 4, 128), "bfloat16", True),
                ("fp32", (1, 512, 8, 2, 64), "float32", True))
KERNELS = ["matmul", "flash_attention", "decode_attention", "lru_scan", "rwkv_scan",
           "lru_scan_bwd", "rwkv_scan_bwd", "flash_attention_bwd", "adamw"]
#: what ``counts()`` reads: every kernel's launches, and the leaves the AdamW
#: kernel updated
COUNTERS = KERNELS + ["adamw_leaves"]
#: the AdamW kernel's launches an update (norm, finish, update), whatever the leaves
ADAMW_LAUNCHES = 3
#: AdamW's kernel timed at seamless-m4t-large-v2's 726 leaves (1.63 B fp32
#: parameters: p, g, m and v are 26.1 GB; rwkv6-7b's 4.28 B do not fit
#: beside this process's other tensors)
ADAMW_CELL = "seamless_m4t_large_v2"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bwd_rel(got, want) -> float:
    """||got - want|| / ||want|| in fp32 (0 when both are zero)."""
    d = (got.float() - want.float()).norm().item()
    w = want.float().norm().item()
    return d / w if w > 0 else (0.0 if d == 0 else math.inf)


@contextlib.contextmanager
def backward_events(fn_name: str = "_Flash"):
    """CUDA events around each call of ``ops.<fn_name>.backward`` (flash
    attention's, or ``_Rwkv``'s) while the block runs: yields the list of
    (start, end) pairs, to be read after a synchronize (the backward's
    device time, launches included)."""
    import torch

    from repro_torch.kernels import ops

    fn_cls = getattr(ops, fn_name)
    pairs, backward = [], fn_cls.backward

    def timed(ctx, *grads):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        got = backward(ctx, *grads)
        e1.record()
        pairs.append((e0, e1))
        return got

    fn_cls.backward = staticmethod(timed)
    try:
        yield pairs
    finally:
        fn_cls.backward = backward


def events_total_ms(pairs) -> float:
    return sum(a.elapsed_time(b) for a, b in pairs)


def _tensors(x) -> list:
    """The tensors of a kernel's result (one tensor, or the scans' pair)."""
    return list(x) if isinstance(x, (tuple, list)) else [x]


def counts() -> dict:
    """Every kernel's launch count (each wrapper adds one where it launches;
    AdamW's three an update) and the leaves the AdamW kernel updated."""
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm

    return {"matmul": mm.launches, "flash_attention": fa.launches,
            "decode_attention": da.launches, **ls.launches, "flash_attention_bwd": fa.bwd_launches,
            "adamw": aw.launches, "adamw_leaves": aw.leaves}


def reset_counts() -> None:
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm

    aw.launches = 0
    aw.leaves = 0
    mm.launches = 0
    fa.launches = 0
    fa.bwd_launches = 0
    da.launches = 0
    for n in ls.launches:
        ls.launches[n] = 0


def adamw_updates(launched: dict, cfg, what: str) -> int:
    """The AdamW updates a path ran through the kernel, each
    ``ADAMW_LAUNCHES`` launches over every leaf of ``cfg``'s model (checked)."""
    from repro_torch.models import ExecConfig, TrainModel

    n_leaves = len(TrainModel(cfg, ExecConfig(), device="meta").params())
    updates = launched["adamw"] // ADAMW_LAUNCHES
    check(launched["adamw"] == ADAMW_LAUNCHES * updates and launched["adamw_leaves"] == n_leaves * updates,
          f"{what}: the AdamW kernel launched {launched['adamw']} times over {launched['adamw_leaves']} "
          f"leaves, not {ADAMW_LAUNCHES} launches over {n_leaves} leaves an update")
    return updates


def other_launches(launched: dict, *kernels) -> dict:
    """The counts of ``launched`` other than ``kernels`` and AdamW's."""
    return {k_: n_ for k_, n_ in launched.items() if k_ not in (*kernels, "adamw", "adamw_leaves")}


def adamw_tree(dev, shapes, dtype, gen) -> dict:
    """p, g, m and v of a tree of ``shapes`` on the card (fp32 masters;
    ``dtype`` for the state), with the lr and bias corrections of step 1."""
    import torch

    def rand(s_, scale, dt=torch.float32):
        return (torch.randn(s_, generator=gen, device=dev) * scale).to(dt)

    ps = [rand(s_, 0.02) for s_ in shapes]
    stepf = torch.ones((), device=dev)
    return {"p": ps, "g": [rand(p_.shape, 1e-4) for p_ in ps],
            "m": [rand(p_.shape, 1e-5, dtype) for p_ in ps],
            "v": [rand(p_.shape, 1e-5, dtype).square() for p_ in ps],
            "kw": dict(lr=torch.full((), 1e-3, device=dev), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                       c1=1.0 - torch.pow(torch.full((), 0.9, device=dev), stepf),
                       c2=1.0 - torch.pow(torch.full((), 0.95, device=dev), stepf))}


def adamw_check(dev, gen) -> float:
    """Phase 2's AdamW: the kernel against its plain version on a ragged tree
    (lengths 1 to 65541 and a leaf 4 bytes past a 16-byte boundary), fp32
    and bf16 state, 3 steps with the clip engaged; returns the worst error
    over each fp32 leaf's largest magnitude (bf16 tensors: within one step)."""
    import torch

    from repro_torch.kernels import adamw as aw

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        t = adamw_tree(dev, [(1,), (3,), (4097,), (65541,), (16384,), (3, 16384), (5001,)], dtype, gen)
        t["p"][-1] = t["p"][-1].flatten()[1:]  # 4 bytes past the boundary: element loads
        for k_ in "gmv":
            t[k_][-1] = t[k_][-1].flatten()[1:].clone()
        plain = {k_: [x_.clone() for x_ in t[k_]] for k_ in "pmv"}
        for step_ in range(3):
            grads = [torch.randn(p_.shape, generator=gen, device=dev) * 0.1 for p_ in t["p"]]
            before = aw.launches
            nk = aw.adamw_update(t["p"], grads, t["m"], t["v"], clip_norm=1.0, **t["kw"])
            check(aw.launches == before + ADAMW_LAUNCHES, f"adamw: {aw.launches - before} launches an update")
            np_ = aw.adamw_plain(plain["p"], [g_.clone() for g_ in grads], plain["m"], plain["v"],
                                 clip_norm=1.0, **t["kw"])
            check(float(np_) > 1.0 and abs(float(nk) - float(np_)) <= 1e-6 * float(np_),
                  f"adamw: global norm {float(nk)} against the plain version's {float(np_)}")
        for k_ in "pmv":
            for got, want in zip(t[k_], plain[k_]):
                step = 2.0 ** -8 if got.dtype == torch.bfloat16 or dtype == torch.bfloat16 else 0.0
                err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
                check(err <= max(step, 1e-6), f"adamw {dtype} state: {k_} off by {err:.2e} of its scale")
                if got.dtype == torch.float32 and dtype == torch.float32:
                    worst = max(worst, err)
    return worst


def adamw_times(dev, gen, cuda_ms) -> dict:
    """Phase 7's AdamW: the kernel at ``ADAMW_CELL``'s leaf shapes in fp32
    beside its plain version, its bound (32 bytes a parameter) and
    ``torch._fused_adamw_`` (a yardstick the port never calls; it computes
    no global-norm clip)."""
    import torch

    from repro_torch import configs as tconfigs
    from repro_torch.core.costs import H100_SXM, roofline_terms
    from repro_torch.kernels import adamw as aw
    from repro_torch.models import ExecConfig, TrainModel

    params = TrainModel(tconfigs.get(ADAMW_CELL), ExecConfig(), device="meta").params()
    t = adamw_tree(dev, [params[k_].shape for k_ in sorted(params)], torch.float32, gen)
    p, g, m, v, kw = t["p"], t["g"], t["m"], t["v"], t["kw"]
    steps = [torch.ones((), device=dev) for _ in p]
    before = aw.launches
    aw.adamw_update(p, g, m, v, clip_norm=1.0, **kw)
    launches = aw.launches - before
    row = {"tuned": cuda_ms(lambda: aw.adamw_update(p, g, m, v, clip_norm=1.0, **kw), 5),
           "plain": cuda_ms(lambda: aw.adamw_plain(p, g, m, v, clip_norm=1.0, **kw), 1),
           "library": cuda_ms(lambda: torch._fused_adamw_(
               p, g, m, v, [], steps, lr=1e-3, beta1=0.9, beta2=0.95, weight_decay=0.1, eps=1e-8,
               amsgrad=False, maximize=False), 5),
           "terms": roofline_terms(*aw.flops_bytes(p, g, m), "float32", H100_SXM), "main_path": None,
           "leaves": len(p), "parameters": sum(p_.numel() for p_ in p),
           "launches_per_update": launches}
    row["default"] = row["tuned"]
    return row


def trace_busy(out: Path, fn, steps: int, name: str) -> tuple:
    """(device-busy ms, kernel launches) per call of ``fn`` from a
    ``torch.profiler`` trace of ``steps`` calls (the union of the kernel,
    copy and memset intervals); the trace is kept, gzipped, in ``out``."""
    import gzip

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    path = out / f"trace_{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    with gzip.open(f"{path}.gz", "wt") as fh:
        json.dump(events, fh)
    path.unlink()
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -math.inf
    for t0_, t1_ in spans:
        busy += max(0.0, t1_ - max(t0_, end))
        end = max(end, t1_)
    return busy / 1e3 / steps, len(spans) / steps


def decode_profile(out: Path, phase, arch, model, batch) -> dict:
    """Where one decode step's time goes, eager against a CUDA graph, and
    the graph's greedy tokens against the eager loop's, from fresh
    prefills of the served batch on the kernel path."""
    import gc

    import torch

    from repro_torch.launch import serve

    P = batch["tokens"].shape[1]
    B = batch["tokens"].shape[0]

    def fresh():
        h_, st_ = model.prefill(batch)
        return model.logits(h_[:, None])[:, 0].argmax(-1)[:, None], st_

    tok, st = fresh()
    eager_toks, eager_logits = [], []
    for i in range(DECODE_TOKENS):
        lg, st = model.decode_step(tok, st, P + i)
        tok = lg.argmax(-1)[:, None]
        eager_toks.append(tok)
        eager_logits.append(lg)
    state = {"tok": tok, "st": st, "pos": P + DECODE_TOKENS}

    def eager_step():
        lg_, state["st"] = model.decode_step(state["tok"], state["st"], state["pos"])
        state["tok"] = lg_.argmax(-1)[:, None]
        state["pos"] += 1

    walls = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        eager_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0_) * 1e3)
    busy, kernels = trace_busy(out, eager_step, 3, f"{arch}_eager")
    del state, st, tok
    gc.collect()

    prof = {"eager_wall_ms": sorted(walls)[len(walls) // 2], "eager_wall_ms_min": min(walls),
            "eager_wall_ms_max": max(walls), "eager_busy_ms": busy, "eager_kernels": kernels}
    got = {}
    for k in (1, 8):
        tok, st = fresh()
        graphs = serve.DecodeGraphs(model, tok, st, P)
        del tok, st
        t0_ = time.perf_counter()
        run = graphs.build(k)
        prof[f"capture_k{k}_s"] = time.perf_counter() - t0_
        token, states, pos = graphs.token, graphs.states, graphs.pos
        toks_, logits_ = [], []
        for _ in range(DECODE_TOKENS // k):
            token, states, pos, toks = run(token, states, pos)
            toks_.append(toks.clone())
            logits_.append(run.logits.clone())
        got[k] = (torch.cat(toks_, dim=1), logits_)
        if k == 8:
            reps = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0_ = time.perf_counter()
                run(token, states, pos)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0_) * 1e3 / k)
            gbusy, gkernels = trace_busy(out, lambda: run(token, states, pos), 1, f"{arch}_graph8")
            prof.update(graph_step_ms=sorted(reps)[len(reps) // 2], graph_step_ms_min=min(reps),
                        graph_step_ms_max=max(reps), graph_busy_ms=gbusy / k,
                        graph_kernels=gkernels / k)
        del run, graphs, token, states, pos
        gc.collect()
    eager_t = torch.cat(eager_toks, dim=1)
    same = all(torch.equal(got[k][0], eager_t) for k in got)
    mag = max(lg.float().abs().max().item() for lg in eager_logits)
    dlog = max((g_.float() - e_.float()).abs().max().item()
               for g_, e_ in zip(got[1][1], eager_logits))
    prof.update(tokens_equal=same, logits_max_abs_diff=dlog, logits_max_abs=mag,
                eager_tok_s=B * 1e3 / prof["eager_wall_ms"], graph_tok_s=B * 1e3 / prof["graph_step_ms"])
    print(f"[{phase}] {arch} decode profile (batch {B}, position {P}+): eager step wall "
          f"{prof['eager_wall_ms']:.2f} ms (min {prof['eager_wall_ms_min']:.2f}, max "
          f"{prof['eager_wall_ms_max']:.2f}), device busy {busy:.3f} ms "
          f"({busy / prof['eager_wall_ms']:.3f} of the step), {kernels:.0f} kernel launches a step; "
          f"8-step graph replay {prof['graph_step_ms']:.3f} ms a step (min "
          f"{prof['graph_step_ms_min']:.3f}, max {prof['graph_step_ms_max']:.3f}), device busy "
          f"{prof['graph_busy_ms']:.3f} ms a step, {prof['graph_kernels']:.0f} kernels a step; "
          f"captures {prof['capture_k1_s']:.2f} s (k=1) / {prof['capture_k8_s']:.2f} s (k=8); "
          f"{prof['eager_tok_s']:.1f} -> {prof['graph_tok_s']:.1f} tok/s per step")
    ok = same and dlog <= LOGITS_TOL * mag
    print(f"[{phase}] {arch} first {DECODE_TOKENS} greedy tokens, eager vs 1-step and 8-step graphs: "
          f"equal={same}; logits max |d| {dlog:.4e} (max |logit| {mag:.3f}, limit "
          f"{LOGITS_TOL:g} x max |logit|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{arch}: decode through CUDA graphs differs from the eager loop")
    return prof


def sdpa_forms(phase, smi: str) -> dict:
    """The plain attention's scores in the reference's form (the package's
    ``_sdpa``: bf16 q and k multiplied with fp32 output) against an inline
    copy of the form it replaced (q and k upcast to fp32 first), on the
    same tensors in one process at the ``SDPA_FORMS`` shapes: CUDA-event
    ms of each (the two in turns, median), the peak bytes each allocates
    above what was live, and the two outputs against each other."""
    import gc

    import torch

    from repro_torch.models.attention import NEG_INF, _sdpa

    def upcast(q, k, v, mask):
        B, Sq, H, hd = q.shape
        Kh = k.shape[1]
        qh = q.reshape(B, Sq, Kh, H // Kh, hd)
        scores = torch.einsum("bqkgh,bksh->bkgqs", qh.float(), k.float())
        scores = scores * (1.0 / math.sqrt(hd))
        scores = torch.where(mask[None, None, None], scores, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bkgqs,bksh->bqkgh", p, v).reshape(B, Sq, H, hd)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    forms = {"bf16 product": _sdpa, "upcast": upcast}
    rows = {}
    for label, (B, Sq, H, hd), Kh, Skv, causal in SDPA_FORMS:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Kh, Skv, hd), generator=gen, device=dev).bfloat16() for _ in range(2))
        q_pos = torch.arange(Skv - Sq, Skv, device=dev)
        mask = (torch.arange(Skv, device=dev)[None] <= q_pos[:, None]) if causal else \
            torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
        got, peak = {}, {}
        for name, fn in forms.items():
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            got[name] = fn(q, k, v, mask)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated(dev) - base
        ms = {name: [] for name in forms}
        for name in [*forms, *reversed(forms)] * SDPA_REPS:
            t0_, t1_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0_.record()
            forms[name](q, k, v, mask)
            t1_.record()
            torch.cuda.synchronize()
            ms[name].append(t0_.elapsed_time(t1_))
        new, old = got["bf16 product"], got["upcast"]
        diff = (new.float() - old.float()).abs()
        ok = new.dtype == old.dtype == torch.bfloat16 and bool(
            (diff <= SDPA_TOL + SDPA_TOL * old.float().abs()).all())
        med = {name: sorted(t_)[len(t_) // 2] for name, t_ in ms.items()}
        rows[label] = {"q": [B, Sq, H, hd], "kv": [B, Kh, Skv, hd], "causal": causal, "ms": med,
                       "ms_all": ms, "peak_bytes": peak, "max_abs_diff": diff.max().item()}
        print(f"[{phase}] _sdpa {label}: q {(B, Sq, H, hd)}, k/v {(B, Kh, Skv, hd)} bf16, causal={causal}: "
              f"bf16 product with fp32 output {med['bf16 product']:.3f} ms, peak "
              f"{peak['bf16 product'] / 1e9:.3f} GB; upcast form {med['upcast']:.3f} ms, peak "
              f"{peak['upcast'] / 1e9:.3f} GB ({med['upcast'] / med['bf16 product']:.2f}x the time, "
              f"{peak['upcast'] / max(peak['bf16 product'], 1):.2f}x the peak; {SDPA_REPS * 2} calls "
              f"each in turns); outputs max |d| {diff.max().item():.3e} (max |o| "
              f"{old.float().abs().max().item():.3f}, allclose(atol={SDPA_TOL:g}, rtol={SDPA_TOL:g}) "
              f"{'ok' if ok else 'FAIL'}); {smi}")
        check(ok, f"_sdpa {label}: the two forms disagree")
        del q, k, v, mask, got, new, old, diff
    return rows


def decode_scores_trace(phase, arch, model, batch) -> dict:
    """One eager decode step of a served model under ``torch.profiler``
    with shapes recorded: the scores come from ``aten::bmm`` in its
    fp32-output overload (three inputs: q, the cache's K, the dtype), one
    per attention layer, and no copy or conversion takes a tensor of the K
    cache's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    h, st = model.prefill(batch)
    tok = model.logits(h[:, None])[:, 0].argmax(-1)[:, None]
    P = batch["tokens"].shape[1]
    model.decode_step(tok, st, P)  # warm
    cache = next(s_["kv"]["k"] for s_ in st if "kv" in s_)
    n_attn = sum(1 for s_ in st if "kv" in s_)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        model.decode_step(tok, st, P + 1)
        torch.cuda.synchronize()
    events = prof.events()
    bmm = [e_ for e_ in events if e_.name == "aten::bmm"]
    fp32_out = [e_ for e_ in bmm if len(e_.input_shapes) == 3]
    copies = [e_ for e_ in events if e_.name in ("aten::to", "aten::_to_copy", "aten::copy_", "aten::clone",
                                                 "aten::contiguous")
              and any(list(sh_) == list(cache.shape) for sh_ in e_.input_shapes)]
    res = {"cache_shape": list(cache.shape), "attention_layers": n_attn, "bmm": len(bmm),
           "bmm_fp32_output": len(fp32_out), "cache_sized_copies": len(copies),
           "bmm_inputs": [list(map(list, e_.input_shapes)) for e_ in fp32_out[:1]]}
    ok = len(fp32_out) == n_attn and not copies
    print(f"[{phase}] {arch} one decode step under torch.profiler: {len(bmm)} aten::bmm, "
          f"{len(fp32_out)} of them with an output dtype (inputs {res['bmm_inputs']}) for "
          f"{n_attn} attention layers; {len(copies)} copies or conversions of a tensor of the K "
          f"cache's shape {tuple(cache.shape)} {'ok' if ok else 'FAIL'}")
    check(ok, f"{arch}: a decode step upcasts the cache or misses the fp32-output product: {res}")
    del h, st, tok, cache, prof, events
    return res


def family_phases(out: Path, smi: str) -> dict:
    """Phases 12-15 and 20-21, serving the encoder-decoder, VLM and MoE
    families, starcoder2-15b and the attention's two forms on a
    card nothing else holds memory on (``main`` runs this in a child
    process: ``--family-phases``), one model at a time.  Returns the
    kernels' launch counts over the serve runs (the main path)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import ExecConfig, blocks, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)  # a context before the memory statistics are read
    print(f"[12] the families start with torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB on {smi}")
    launched_total = {n: 0 for n in COUNTERS}
    report = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def served(phase, arch, argv, run):
        """One ``serve`` run, counted as the main path: (result, launches,
        flash launches by design, the ``causal`` of every flash call)."""
        reset_counts()
        by_design = dict(fa.launches_by_design)
        flags = []
        real = ops.flash_attention

        def spy(*args_, **kw_):
            flags.append(kw_["causal"])
            return real(*args_, **kw_)

        torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        ops.flash_attention = spy
        try:
            with contextlib.redirect_stdout(buf):
                res = serve.serve(["--arch", arch, *argv])
        finally:
            ops.flash_attention = real
        launched = counts()
        design = {d: n - by_design[d] for d, n in fa.launches_by_design.items()}
        for n, c in launched.items():
            launched_total[n] += c
        for line in buf.getvalue().splitlines():
            print(f"[{phase}] {arch} run {run}: {line}")
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        graphs = res.pop("graphs")  # the static set holds the rings and the context K/V
        cfg = res["model"].cfg
        print(f"[{phase}] {arch} run {run}: prefill {res['prefill_ms']:.1f} ms, decode "
              f"{res['decode_tok_s']:.1f} tok/s, k={res['k']}, db_hit={res['db_hit']}, "
              f"{graphs.captures} decode depths captured as CUDA graphs, router {res['router']}; "
              f"launches {launched}, flash by design {design}, flash causal flags "
              f"{sorted(set(flags))}; torch.cuda.max_memory_allocated {peak:.2f} GB; {smi}")
        h = res["hidden"]
        check(h.shape == (res["batch"]["tokens"].shape[0], cfg.d_model)
              and bool(torch.isfinite(h.float()).all()),
              f"{arch} run {run}: prefill hidden {tuple(h.shape)} not finite of width d_model")
        check(graphs.captures >= 1 and res["router"]["inband_builds"] == 0
              and res["router"]["candidate_failures"] == 0,
              f"{arch} run {run}: decode captured {graphs.captures} graphs, router {res['router']}")
        check(peak < 80.0, f"{arch} run {run}: peak memory {peak:.2f} GB")
        del graphs
        free()
        return res, launched, design, flags, peak

    def weights(phase, arch, model):
        n = sum(p_.numel() for p_ in model.parameters())
        gb = sum(p_.numel() * p_.element_size() for p_ in model.parameters()) / 1e9
        print(f"[{phase}] {arch}: {n / 1e9:.3f} B parameters, {gb:.3f} GB as served; "
              f"torch.cuda.memory_allocated {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB")
        return n

    def summary(res, peak):
        return {"prefill_ms": res["prefill_ms"], "decode_tok_s": res["decode_tok_s"], "k": res["k"],
                "db_hit": res["db_hit"], "peak_gb": peak}

    # 12. seamless-m4t-large-v2 at full width and depth: the encoder's 24
    # layers on the flash kernel, non-causal, at head dim 64
    runs = []
    for run in (1, 2):
        res, launched, design, flags, peak = served(
            12, SEAMLESS, [*SERVE_ARGS, "--db", str(out / f"serve_{SEAMLESS}.json")], run)
        check(launched["flash_attention"] == SEAMLESS_ENC_LAYERS
              and design["wgmma"] == SEAMLESS_ENC_LAYERS and flags == [False] * SEAMLESS_ENC_LAYERS,
              f"{SEAMLESS} run {run}: flash launched {launched['flash_attention']} times ({design}, "
              f"causal {flags}), expected {SEAMLESS_ENC_LAYERS} non-causal wgmma launches")
        check(all(n == 0 for name, n in launched.items() if name != "flash_attention"),
              f"{SEAMLESS} run {run}: unexpected launches {launched}")
        check(run == 1 or res["db_hit"], f"{SEAMLESS} run 2 was not a tuning DB hit")
        runs.append(summary(res, peak))
        if run == 1:
            h_first = res["hidden"].clone()
            del res
            free()
    check(torch.equal(h_first, res["hidden"]), f"{SEAMLESS}: the two runs' prefills differ")
    model, batch, h = res["model"], res["batch"], res["hidden"]
    del res, h_first
    cfg = model.cfg
    n_params = weights(12, SEAMLESS, model)
    # the kernel on the served inputs: the last encoder layer's q, k, v
    captured, real = {}, ops.flash_attention

    def capture(q_, k_, v_, **kw_):
        captured.update(args=[t_.detach().clone() for t_ in (q_, k_, v_)], kw=kw_)
        return real(q_, k_, v_, **kw_)

    ops.flash_attention = capture
    try:
        model.prefill(batch)
    finally:
        ops.flash_attention = real
    (cq, ck, cv), ckw = captured["args"], captured["kw"]
    got = real(cq, ck, cv, causal=ckw["causal"], block_q=ckw["block_q"], block_kv=ckw["block_kv"])
    want = fa.flash_attention_plain(cq.transpose(1, 2), ck, cv, causal=ckw["causal"],
                                    block_q=ckw["block_q"], block_kv=ckw["block_kv"]).transpose(1, 2)
    # served activations reach |o| ~ 3, where one bf16 step (2^-6 in [2, 4))
    # is above TOL's atol + rtol |o| for |o| < 2.12: an element outside TOL
    # must be within one bf16 rounding step of the plain value
    tol = TOL["flash_attention"]["bfloat16"]
    g32, w32 = got.float(), want.float()
    diff = (g32 - w32).abs()
    flash_err = diff.max().item()
    outside = diff > tol + tol * w32.abs()
    step = torch.pow(2.0, torch.floor(torch.log2(w32.abs().clamp_min(2.0 ** -126))) - 7)
    ok = bool((diff[outside] <= step[outside]).all()) and math.isfinite(flash_err)
    print(f"[12] flash_attention on the last encoder layer's served inputs q{tuple(cq.shape)} "
          f"kv{tuple(ck.shape)} {str(cq.dtype)[6:]} causal={ckw['causal']} blocks "
          f"{ckw['block_q']}/{ckw['block_kv']}: max_abs_err={flash_err:.3e} max|plain|="
          f"{w32.abs().max().item():.4g}; {int(outside.sum())} of {diff.numel()} elements outside "
          f"allclose(atol={tol:g}, rtol={tol:g}), each within one bf16 step of the plain value: "
          f"{'ok' if ok else 'FAIL'}")
    check(ok and not ckw["causal"], f"{SEAMLESS}: the encoder's flash kernel disagrees with its plain version")
    del g32, w32, diff, outside, step
    del captured, cq, ck, cv, got, want
    free()
    model.exec_cfg = ExecConfig(attn_impl="xla", rec_chunk=4)
    h_plain, _ = model.prefill(batch)
    err_bf16 = (h.float() - h_plain.float()).abs()
    print(f"[12] {SEAMLESS} bf16 as served, kernel path vs plain path: max |dh| "
          f"{err_bf16.max().item():.4e}, mean {err_bf16.mean().item():.4e}, max |h| "
          f"{h_plain.float().abs().max().item():.4f} (rounding spread, not held)")
    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=4)
    del h, h_plain, _, err_bf16
    free()
    prof = decode_profile(out, 12, SEAMLESS, model, batch)
    free()
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    hidden32 = {}
    for impl in ("cuda", "xla"):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=4)
        hidden32[impl], _ = model.prefill(batch)
        del _
        free()
    hk, hp = hidden32["cuda"], hidden32["xla"]
    err = (hk - hp).abs().max().item()
    ok = hk.dtype == torch.float32 and bool(torch.allclose(hk, hp, atol=HIDDEN_TOL, rtol=HIDDEN_TOL))
    print(f"[12] {SEAMLESS} fp32 arithmetic on the served weights, kernel path (the encoder on "
          f"the fp32 flash kernel) vs plain path: max |dh| {err:.4e}, max |h| "
          f"{hp.abs().max().item():.4f}, allclose(atol={HIDDEN_TOL:g}, rtol={HIDDEN_TOL:g}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok and math.isfinite(err), f"{SEAMLESS}: kernel path disagrees with the plain path")
    print(f"[12] {SEAMLESS} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, decode "
          f"tok/s {[round(r['decode_tok_s'], 1) for r in runs]} (batch 8, frames 4096, prompt 2048, "
          f"64 new tokens; {SEAMLESS_ENC_LAYERS} non-causal wgmma flash launches per prefill; {smi})")
    report[SEAMLESS] = {"runs": runs, "params": n_params, "decode_profile": prof,
                        "flash_served_max_abs_err": flash_err, "hidden_fp32_max_abs_diff": err}
    del model, batch, hidden32, hk, hp
    free()

    def served_twice(phase, arch):
        """Two serve runs on one DB (the second a DB hit), no kernel
        launched; returns the second run's model and batch and both runs'
        numbers."""
        runs_ = []
        for run_ in (1, 2):
            res_, launched_, _, _, peak_ = served(
                phase, arch, [*SERVE_ARGS, "--db", str(out / f"serve_{arch}.json")], run_)
            check(all(n_ == 0 for n_ in launched_.values()), f"{arch}: unexpected launches {launched_}")
            check(run_ == 1 or res_["db_hit"], f"{arch} run 2 was not a tuning DB hit")
            runs_.append(summary(res_, peak_))
            if run_ == 1:
                h_first_ = res_["hidden"].clone()
                del res_
                free()
        check(torch.equal(h_first_, res_["hidden"]), f"{arch}: the two runs' prefills differ")
        return res_["model"], res_["batch"], runs_

    # 13. moonshot-v1-16b-a3b at full width and depth: MoE, 64 experts, top-6
    model, batch, runs = served_twice(13, MOONSHOT)
    free()
    cfg = model.cfg
    n_params = weights(13, MOONSHOT, model)
    # the dispatch as served: the capacity branch at prefill (with drops),
    # drop-free in decode
    stats, real_moe = [], blocks.moe_apply

    def moe_spy(cfg_, p_, x_):
        r_ = moe.route(cfg_, p_, x_.reshape(-1, x_.shape[-1]))
        stats.append((x_.shape[0] * x_.shape[1], r_["capacity"], (~r_["keep"]).sum()))
        return real_moe(cfg_, p_, x_)

    blocks.moe_apply = moe_spy
    try:
        h_, st_ = model.prefill(batch)
        pre = [(t_, c_, int(d_)) for t_, c_, d_ in stats]
        stats.clear()
        model.decode_step(model.logits(h_[:, None])[:, 0].argmax(-1)[:, None], st_,
                          batch["tokens"].shape[1])
        dec = [(t_, c_, int(d_)) for t_, c_, d_ in stats]
    finally:
        blocks.moe_apply = real_moe
    del h_, st_, stats
    free()
    T, K = pre[0][0], cfg.top_k
    drops = [d_ for _, _, d_ in pre]
    print(f"[13] {MOONSHOT} prefill dispatch: {len(pre)} MoE layers, T = {T} tokens, T*K = {T * K} "
          f"assignments (> {moe.DROP_FREE_ASSIGNMENTS}: the capacity branch), C = "
          f"{sorted({c_ for _, c_, _ in pre})} slots per expert; dropped per layer {drops} (total "
          f"{sum(drops)} of {T * K * len(pre)}); decode step: T*K = {dec[0][0] * K}, C = "
          f"{sorted({c_ for _, c_, _ in dec})}, dropped {sum(d_ for _, _, d_ in dec)}")
    check(len(pre) == cfg.n_layers and all(c_ == moe.capacity(cfg, T) == 1920 for _, c_, _ in pre)
          and T * K > moe.DROP_FREE_ASSIGNMENTS, f"{MOONSHOT}: prefill did not take the capacity branch")
    check(len(dec) == cfg.n_layers and all(c_ == t_ * K == 48 and d_ == 0 for t_, c_, d_ in dec),
          f"{MOONSHOT}: decode is not drop-free: {dec[:3]}")
    prof = decode_profile(out, 13, MOONSHOT, model, batch)
    print(f"[13] {MOONSHOT} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, decode "
          f"tok/s {[round(r['decode_tok_s'], 1) for r in runs]} (batch 8, prompt 2048, 64 new tokens; "
          f"{smi})")
    report[MOONSHOT] = {"runs": runs, "params": n_params, "decode_profile": prof, "prefill_drops": drops,
                        "capacity_prefill": pre[0][1], "capacity_decode": dec[0][1]}
    del model, batch
    free()

    # 14. qwen2-7b at full width and depth (no kernel: prefill and decode
    # attend through the cache, as in the JAX model)
    model, batch, runs = served_twice(14, QWEN)
    free()
    n_params = weights(14, QWEN, model)
    prof = decode_profile(out, 14, QWEN, model, batch)
    scores_trace = decode_scores_trace(14, QWEN, model, batch)
    print(f"[14] {QWEN} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, decode "
          f"tok/s {[round(r['decode_tok_s'], 1) for r in runs]} (batch 8, prompt 2048, 64 new tokens; "
          f"{smi})")
    report[QWEN] = {"runs": runs, "params": n_params, "decode_profile": prof,
                    "decode_scores_trace": scores_trace}
    del model, batch
    free()

    # 15. llama-3.2-vision-11b at full width and depth: 40 layers, 8 of them
    # with cross attention over the 6400 context tokens of ctx_embeds
    model, batch, runs = served_twice(15, LLAMA_V)
    free()
    cfg = model.cfg
    n_params = weights(15, LLAMA_V, model)
    n_cross = sum(1 for kind in cfg.pattern if kind == "cross")
    ctx = batch["ctx_embeds"]
    print(f"[15] {LLAMA_V}: {cfg.n_layers} layers, {n_cross} with cross attention; ctx_embeds "
          f"{tuple(ctx.shape)} {str(ctx.dtype)[6:]} on {ctx.device}")
    check(cfg.n_layers == 40 and n_cross == 8 and tuple(ctx.shape) == (8, cfg.ctx_tokens, cfg.d_model)
          and cfg.ctx_tokens == 6400, f"{LLAMA_V}: not served at full width and depth")
    prof = decode_profile(out, 15, LLAMA_V, model, batch)
    print(f"[15] {LLAMA_V} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, decode "
          f"tok/s {[round(r['decode_tok_s'], 1) for r in runs]}, peak GB "
          f"{[round(r['peak_gb'], 2) for r in runs]} (batch 8, ctx 6400, prompt 2048, 64 new tokens; "
          f"{smi})")
    report[LLAMA_V] = {"runs": runs, "params": n_params, "decode_profile": prof}
    del model, batch, ctx
    free()

    # 15. arctic-480b, --tiny on the card
    for arch in FAMILY_TINY:
        res, launched, _, _, peak = served(15, arch, [*TINY_SERVE_ARGS, "--db",
                                                      str(out / f"serve_{arch}_tiny.json")], 1)
        check(all(n == 0 for n in launched.values()), f"{arch} tiny: unexpected launches {launched}")
        model, batch = res["model"], res["batch"]
        runs = [summary(res, peak)]
        del res
        prof = decode_profile(out, 15, f"{arch}_tiny", model, batch)
        report[f"{arch}_tiny"] = {"runs": runs, "decode_profile": prof}
        del model, batch
        free()
    # 20. starcoder2-15b at full width and depth: LayerNorm, the GELU MLP
    # and the q/k/v biases (no kernel, as in the JAX model)
    model, batch, runs = served_twice(20, STARCODER)
    free()
    cfg = model.cfg
    n_params = weights(20, STARCODER, model)
    tree = model.layers[0].tree()
    parts = {"norm": cfg.norm, "ffn": cfg.ffn, "norm1 bias": tuple(tree["norm1"]["bias"].shape),
             "ffn biases": (tuple(tree["ffn"]["bi"].shape), tuple(tree["ffn"]["bo"].shape)),
             "q/k/v biases": tuple(tuple(tree["attn"][w]["b"].shape) for w in ("wq", "wk", "wv"))}
    print(f"[20] {STARCODER}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.d_head}, d_ff {cfg.d_ff}; the parts its config adds: {parts}")
    check(cfg.norm == "layernorm" and cfg.ffn == "gelu" and cfg.qkv_bias
          and parts["q/k/v biases"] == ((cfg.n_heads * cfg.d_head,), (cfg.n_kv_heads * cfg.d_head,),
                                        (cfg.n_kv_heads * cfg.d_head,)),
          f"{STARCODER}: the served model lacks its LayerNorm, GELU MLP or q/k/v biases: {parts}")
    prof = decode_profile(out, 20, STARCODER, model, batch)
    print(f"[20] {STARCODER} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, decode "
          f"tok/s {[round(r['decode_tok_s'], 1) for r in runs]}, peak GB "
          f"{[round(r['peak_gb'], 2) for r in runs]} (batch 8, prompt 2048, 64 new tokens; {smi})")
    report[STARCODER] = {"runs": runs, "params": n_params, "decode_profile": prof}
    del model, batch, tree
    free()

    # 21. the plain attention's two forms, timed on the same tensors
    report["sdpa_forms"] = sdpa_forms(21, smi)
    free()

    (out / "family_report.json").write_text(json.dumps(report, indent=1))
    return launched_total


def live_cuda_report(phase: str, dev) -> None:
    """What still holds CUDA memory: the serving objects alive, and the
    largest live CUDA tensors with what refers to them, two levels up (a
    function's frame by the function's name; none: held only from C++)."""
    import gc
    import threading
    import types

    import torch

    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.runtime import ContextRouter

    gc.collect()
    torch.cuda.empty_cache()
    import warnings

    warnings.filterwarnings("ignore", message=".*reduce_op.*")  # scanning gc touches the old alias
    objs = gc.get_objects()
    alive: dict = {}
    for o_ in objs:
        for cls in (Model, serve.DecodeGraphs, ContextRouter, torch.cuda.CUDAGraph):
            if isinstance(o_, cls):
                alive[cls.__name__] = alive.get(cls.__name__, 0) + 1
    live = sorted((o_ for o_ in objs if isinstance(o_, torch.Tensor) and o_.is_cuda),
                  key=lambda t_: -t_.numel() * t_.element_size())
    del objs
    top = live[:6]
    mine = {id(live), id(top), id(sys._getframe())}

    def holders(o_):
        return [r_ for r_ in gc.get_referrers(o_) if id(r_) not in mine]

    def name(o_):
        if isinstance(o_, dict):
            return f"dict{sorted(map(str, o_))[:4]}"
        if isinstance(o_, types.FunctionType):
            return f"function {o_.__qualname__}"
        if isinstance(o_, types.FrameType):
            names = [k_ for k_, v_ in o_.f_locals.items() if v_ is t_]
            return f"frame of {o_.f_code.co_name}{' (local ' + ', '.join(names) + ')' if names else ''}"
        return type(o_).__name__

    print(f"[{phase}] live CUDA memory: torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB, reserved "
          f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB; {len(live)} live CUDA tensors reachable from "
          f"Python, {sum(t_.numel() * t_.element_size() for t_ in live) / 1e9:.3f} GB; serving objects "
          f"alive {alive}; {threading.active_count()} threads")
    for t_ in top:
        hs = holders(t_)
        mine.add(id(hs))
        up = [f"{name(h_)} <- {[name(g_) for g_ in holders(h_)][:3]}" for h_ in hs[:3]]
        print(f"[{phase}]   {tuple(t_.shape)} {t_.dtype} {t_.numel() * t_.element_size() / 1e9:.3f} GB, "
              f"grad_fn {type(t_.grad_fn).__name__ if t_.grad_fn is not None else None}, held by "
              f"{up or 'nothing in Python (C++ only)'}")


def loss_and_grads(model, batch) -> tuple:
    """Loss and global gradient norm of one forward/backward, no update;
    the gradients stay in ``.grad``."""
    from repro_torch.optim import global_norm
    from repro_torch.train import make_loss_fn

    model.zero_grad(set_to_none=True)
    loss_, _ = make_loss_fn(model)(model.params(), batch)
    loss_.backward()
    grads_ = [p_.grad for p_ in model.params().values()]
    return loss_.item(), global_norm(grads_).item()


def timed_paths(model, batch, fn_cls, rec_chunk: int) -> dict:
    """The kernel path (``attn_impl="cuda"``) against the plain path
    (``"xla"``) on one batch with no update: (loss, global grad norm) of
    each, the kernel path's forward + backward once with ``fn_cls.backward``
    (a scan's autograd function) timed per call, synchronized around each,
    then once more without, and the plain path's; plus the launches of the
    kernel path's two passes."""
    import torch

    from repro_torch.models import ExecConfig

    bwd = []
    backward = fn_cls.backward

    def timed_backward(ctx, *grads):
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        got_ = backward(ctx, *grads)
        torch.cuda.synchronize()
        bwd.append(time.perf_counter() - t_)
        return got_

    def run(impl):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=rec_chunk)
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        got_ = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        return got_, (time.perf_counter() - t0_) * 1e3

    paths = {}
    fn_cls.backward = staticmethod(timed_backward)
    try:
        paths["cuda"], paths["cuda_fb_ms"] = run("cuda")
    finally:
        fn_cls.backward = backward
    paths["launched"] = counts()
    paths["bwd_ms"], paths["bwd_calls"] = sum(bwd) * 1e3, len(bwd)
    _, paths["cuda_fb_free_ms"] = run("cuda")
    paths["xla"], paths["xla_fb_ms"] = run("xla")
    return paths


def train_phases(out: Path, smi: str) -> dict:
    """Phases 10-11 and 22-24, the training main path, on a card nothing else holds
    memory on (``main`` runs this in a child process: ``--train-phases``).
    Returns the kernels' launch counts over the training runs."""
    import dataclasses
    import gc
    import tempfile

    import torch

    from repro_torch import configs as tconfigs
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW, cosine_schedule, tree_leaves
    from repro_torch.runtime import TrainJob
    from repro_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)  # a context before the memory statistics are read
    names = COUNTERS

    gc.collect()
    print(f"[10] training starts with torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB on {smi}")
    train_launches = {n: 0 for n in names}
    train_report = {}

    def add_train_launches(launched):
        for n_, c_ in launched.items():
            train_launches[n_] += c_

    # 10. recurrentgemma-2b at full width and depth through TrainJob
    rg_cfg = tconfigs.get(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    runs10 = {}
    for run in (1, 2):
        reset_counts()
        per_step = []

        def on_step(step_, metrics_, per_step=per_step):
            done_ = [sum(c_[i_] for c_ in per_step) for i_ in (0, 1)]
            per_step.append((ls.launches["lru_scan"] - done_[0], ls.launches["lru_scan_bwd"] - done_[1]))

        job = TrainJob(arch=TRAIN_ARCH, tiny=False, steps=TRAIN_CAP if run == 1 else 4,
                       # lr 1e-3 (the launcher's) with no warmup, so that a dozen
                       # steps move the loss past the batches' spread
                       global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, warmup=0, tune=True,
                       tune_db=str(out / "train.json"), seed=0, device="cuda",
                       stop_after_tuned=2 if run == 1 else None)
        t0 = time.perf_counter()
        hist = job.run(on_step=on_step)
        wall = time.perf_counter() - t0
        launched = counts()
        add_train_launches(launched)
        del job
        gc.collect()
        losses, times_ = hist["loss"], hist["step_time"]
        mbs = [k_["microbatches"] for k_ in hist["knobs"]]
        med = sorted(times_)[len(times_) // 2]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        tuning = "a db hit" if hist["db_hit"] else f"finished after {hist['tuned_at']} steps"
        print(f"[10] {TRAIN_ARCH} train run {run}: {len(losses)} steps in {wall:.1f}s, tuning "
              f"{tuning}, microbatches chosen {hist['final_knobs']}, per step {mbs}")
        print(f"[10] {TRAIN_ARCH} run {run} loss per step: {[round(x_, 4) for x_ in losses]}")
        print(f"[10] {TRAIN_ARCH} run {run} step wall ms per step: {[round(t_ * 1e3, 1) for t_ in times_]}; "
              f"median {med * 1e3:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s "
              f"(batch {TRAIN_BATCH} x {TRAIN_SEQ}); torch.cuda.max_memory_allocated {peak:.2f} GB; "
              f"(lru_scan, lru_scan_bwd) launches per step {per_step}; launches {launched}; {smi}")
        check(all(math.isfinite(x_) for x_ in losses), f"run {run}: a loss is not finite")
        check(all(n_ == (RG_LRU_LAYERS * m_, RG_LRU_LAYERS * m_) for n_, m_ in zip(per_step, mbs)),
              f"run {run}: (lru_scan, lru_scan_bwd) launches per step {per_step} are not "
              f"(1, 1) x {RG_LRU_LAYERS} x microbatches {mbs} (the forward; the backward's one kernel)")
        check(not any(other_launches(launched, "lru_scan", "lru_scan_bwd").values())
              and adamw_updates(launched, rg_cfg, f"run {run}") == len(losses),
              f"run {run}: unexpected launches {launched}, expected one AdamW update a step")
        check(peak < 80.0, f"run {run}: peak memory {peak:.2f} GB")
        if run == 1:
            check(hist["tuned_at"] is not None and len(losses) == hist["tuned_at"] + 2,
                  f"run 1 did not finish tuning within {TRAIN_CAP} steps: {hist['tuned_at']}")
            check(losses[-1] < losses[0], f"run 1: the loss did not fall ({losses[0]} -> {losses[-1]})")
        else:
            check(hist["db_hit"] and len(losses) == 4 and set(mbs) == {hist["final_knobs"]["microbatches"]}
                  and hist["final_knobs"] == runs10[1]["final_knobs"],
                  f"run 2 was not an exact DB hit: {hist['db_hit']} {mbs} {hist['final_knobs']}")
        runs10[run] = {"steps": len(losses), "tuned_at": hist["tuned_at"], "db_hit": hist["db_hit"],
                       "final_knobs": hist["final_knobs"], "microbatches": mbs, "loss": losses,
                       "step_ms": [t_ * 1e3 for t_ in times_], "median_step_ms": med * 1e3,
                       "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med, "peak_gb": peak}
    train_report["recurrentgemma_2b"] = runs10

    # the kernel path against the plain path on one model and one batch, no
    # update; the lru backward timed per call (synchronized around each, as
    # the per-token oracle backward it replaced was timed), then the forward
    # + backward again without those synchronizations
    reset_counts()
    model = TrainModel(rg_cfg, ExecConfig(attn_impl="cuda", rec_chunk=8), device=dev, seed=0)
    batch = make_batch_for(rg_cfg, TRAIN_BATCH, TRAIN_SEQ, step=0, seed=0, device=dev)
    paths = timed_paths(model, batch, ops._Lru, rec_chunk=8)
    launched = paths.pop("launched")
    (lk, gk), (lp, gp) = paths["cuda"], paths["xla"]
    ok = abs(lk - lp) <= 1e-3 * abs(lp) and abs(gk - gp) <= 1e-2 * abs(gp)
    print(f"[10] {TRAIN_ARCH} kernel path vs plain path, batch {TRAIN_BATCH} x {TRAIN_SEQ}, no update: "
          f"loss {lk:.6f} / {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, limit 1e-3), global grad norm "
          f"{gk:.6f} / {gp:.6f} (rel {abs(gk - gp) / abs(gp):.2e}, limit 1e-2) {'ok' if ok else 'FAIL'}; "
          f"forward+backward {paths['cuda_fb_ms']:.1f} ms (kernel path, {paths['bwd_calls']} lru "
          f"backward calls {paths['bwd_ms']:.1f} ms, {paths['bwd_ms'] / paths['bwd_calls']:.3f} ms a "
          f"call, synchronized around each; the earlier two-kernel backward (the forward kernel's "
          f"recompute, then a reverse scan) measured 169.2-181.5 ms forward+backward on an H100, the "
          f"per-token oracle backward before it 847.3 ms, 670.1 ms in 18 calls), {paths['cuda_fb_free_ms']:.1f} ms without the per-call "
          f"synchronizations / {paths['xla_fb_ms']:.1f} ms (plain path); launches {launched}; {smi}")
    check(ok, f"{TRAIN_ARCH}: the kernel path's loss or gradient norm disagrees with the plain path")
    check(launched["lru_scan"] == RG_LRU_LAYERS and launched["lru_scan_bwd"] == RG_LRU_LAYERS
          and paths["bwd_calls"] == RG_LRU_LAYERS,
          f"{TRAIN_ARCH}: one forward + backward launched lru_scan {launched['lru_scan']} times "
          f"(expected {RG_LRU_LAYERS}: the forward) and lru_scan_bwd "
          f"{launched['lru_scan_bwd']} (expected {RG_LRU_LAYERS}) in {paths['bwd_calls']} backward calls")
    train_report["recurrentgemma_2b_paths"] = {
        "loss": [lk, lp], "grad_norm": [gk, gp],
        "forward_backward_ms": [paths["cuda_fb_ms"], paths["xla_fb_ms"]],
        "forward_backward_unsynchronized_ms": paths["cuda_fb_free_ms"],
        "lru_backward_ms": paths["bwd_ms"], "lru_backward_calls": paths["bwd_calls"],
        "per_token_oracle_before": {"forward_backward_ms": 847.3, "lru_backward_ms": 670.1},
        "two_kernel_backward_before": {"forward_backward_ms": [169.2, 181.5]}}
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the async checkpoints of a tiny job restore what on_step saw, bit for bit
    reset_counts()
    with tempfile.TemporaryDirectory(dir=str(out)) as ckpt_dir:
        job = TrainJob(arch=TRAIN_ARCH, tiny=True, steps=6, global_batch=4, seq_len=32,
                       ckpt_dir=ckpt_dir, ckpt_every=2, ckpt_keep=10, ckpt_async=True, device="cuda")
        snaps = {}
        job.run(on_step=lambda step_, m_: snaps.__setitem__(
            step_, [t_.detach().clone() for t_ in tree_leaves(job.state)]))
        equal = {}
        for step_ in (1, 3, 5):
            loaded, got_step, _ = load_checkpoint(ckpt_dir, job.state, step=step_)
            equal[step_] = got_step == step_ and all(
                torch.equal(a_, b_) for a_, b_ in zip(tree_leaves(loaded), snaps[step_]))
        moved = not all(torch.equal(a_, b_) for a_, b_ in zip(snaps[1], snaps[5]))
        print(f"[10] tiny {TRAIN_ARCH} TrainJob, ckpt_async every 2 steps: checkpoints at steps "
              f"{sorted(equal)} restore the on_step snapshot bit for bit: {equal}; weights moved "
              f"between them: {moved}")
        check(all(equal.values()) and moved, "an async checkpoint does not hold its step's snapshot")
        del job, snaps
    add_train_launches(counts())

    # 11. qwen2-7b at full width, depth cut to 2 layers, through make_train_step
    q_cfg = dataclasses.replace(tconfigs.get("qwen2_7b"), n_layers=2, n_groups=0)
    q_batch = make_batch_for(q_cfg, 1, QWEN_SEQ, step=0, seed=0, device=dev)
    q_paths = {}
    for impl in ("cuda", "xla"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        wgmma0 = fa.launches_by_design["wgmma"]
        model = TrainModel(q_cfg, ExecConfig(attn_impl=impl), device=dev, seed=0)
        params = model.params()
        fingerprint = sum(p_.double().square().sum().item() for p_ in params.values())
        opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
        opt_state = opt.init(params)
        step_fn = make_train_step(model, opt)
        walls, mets = [], []
        bwd0 = fa.launches_by_design["bwd_wgmma"]
        with backward_events() as fb_events:
            for i in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, met = step_fn(params, opt_state, q_batch if i == 0 else
                                                 make_batch_for(q_cfg, 1, QWEN_SEQ, step=1, device=dev))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                mets.append({k_: v_.item() for k_, v_ in met.items()})
        launched = counts()
        wgmma = fa.launches_by_design["wgmma"] - wgmma0
        bwd_wgmma = fa.launches_by_design["bwd_wgmma"] - bwd0
        bwd_ms = events_total_ms(fb_events) / 2
        if impl == "cuda":
            add_train_launches(launched)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        q_paths[impl] = {"fingerprint": fingerprint, "loss": mets[0]["loss"],
                         "grad_norm": mets[0]["grad_norm"], "step_ms": walls, "peak_gb": peak,
                         "tokens_per_s": QWEN_SEQ / (walls[1] / 1e3),
                         "flash_launches": launched["flash_attention"], "wgmma": wgmma,
                         "flash_bwd_launches": launched["flash_attention_bwd"], "bwd_wgmma": bwd_wgmma,
                         "flash_bwd_device_ms_per_step": bwd_ms}
        print(f"[11] qwen2-7b 2 layers (d_model {q_cfg.d_model}, {q_cfg.n_heads}/{q_cfg.n_kv_heads} "
              f"heads of {q_cfg.d_head}, d_ff {q_cfg.d_ff}, vocab {q_cfg.vocab_size}; "
              f"{sum(p_.numel() for p_ in params.values()) / 1e9:.3f} B parameters), batch 1 x "
              f"{QWEN_SEQ}, {'kernel' if impl == 'cuda' else 'plain'} path: loss {mets[0]['loss']:.6f}, "
              f"grad norm {mets[0]['grad_norm']:.6f} (before the update); step wall {walls[0]:.1f} ms "
              f"(first), {walls[1]:.1f} ms (second), {QWEN_SEQ / (walls[1] / 1e3):.1f} tokens/s (second); "
              f"peak {peak:.2f} GB; flash_attention launches {launched['flash_attention']} ({wgmma} wgmma), "
              f"flash_attention_bwd launches {launched['flash_attention_bwd']} ({bwd_wgmma} wgmma), the flash "
              f"backward {bwd_ms:.3f} device ms a step (CUDA events around each call, "
              f"{len(fb_events)} calls); weights fingerprint {fingerprint:.6e}; {smi}")
        check(all(math.isfinite(v_) for m_ in mets for v_ in m_.values()), f"qwen2-7b {impl}: non-finite")
        check(peak < 80.0, f"qwen2-7b {impl}: peak memory {peak:.2f} GB")
        del model, params, opt_state, step_fn, opt
    qk, qp = q_paths["cuda"], q_paths["xla"]
    ok = (qk["fingerprint"] == qp["fingerprint"] and abs(qk["loss"] - qp["loss"]) <= 1e-3 * abs(qp["loss"])
          and abs(qk["grad_norm"] - qp["grad_norm"]) <= 1e-2 * abs(qp["grad_norm"]))
    print(f"[11] qwen2-7b kernel path vs plain path from the same weights: loss rel "
          f"{abs(qk['loss'] - qp['loss']) / abs(qp['loss']):.2e} (limit 1e-3), grad norm rel "
          f"{abs(qk['grad_norm'] - qp['grad_norm']) / abs(qp['grad_norm']):.2e} (limit 1e-2) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "qwen2-7b: the kernel path's loss or gradient norm disagrees with the plain path")
    check(qk["flash_launches"] == 2 * QWEN_LAYERS and qk["wgmma"] == 2 * QWEN_LAYERS
          and qp["flash_launches"] == 0,
          f"qwen2-7b: flash launches {qk['flash_launches']} ({qk['wgmma']} wgmma) over two steps, "
          f"expected {2 * QWEN_LAYERS} of the wgmma design; plain path {qp['flash_launches']}")
    check(qk["flash_bwd_launches"] == 2 * QWEN_LAYERS and qk["bwd_wgmma"] == 2 * QWEN_LAYERS
          and qp["flash_bwd_launches"] == 0,
          f"qwen2-7b: flash backward launches {qk['flash_bwd_launches']} ({qk['bwd_wgmma']} wgmma) over two "
          f"steps, expected {2 * QWEN_LAYERS} of the wgmma design; plain path {qp['flash_bwd_launches']}")
    train_report["qwen2_7b_2_layers"] = q_paths
    del q_batch
    gc.collect()
    torch.cuda.empty_cache()

    # 22-23. the encoder-decoder and MoE families trained on the flash kernel
    fam_launches, train_report["families"] = family_train_phases(out, smi)
    add_train_launches(fam_launches)

    # 24. rwkv6-7b at full width, depth cut, on the rwkv scan and its backward kernel
    rwkv_launches, train_report["rwkv6_7b"] = rwkv_train_phase(smi)
    add_train_launches(rwkv_launches)
    (out / "train_report.json").write_text(json.dumps(train_report, indent=1))
    return train_launches


def rwkv_train_phase(smi: str) -> tuple:
    """Phase 24: rwkv6-7b at full width (64 heads of 64, d_ff 14336, vocab
    65536) with ``RWKV_TRAIN_LAYERS`` of its 32 layers, through
    ``make_train_step`` on the kernel path (the scan's tensor-core forward
    and its backward kernel, ``rec_chunk`` ``TRAIN_REC_CHUNK``), batch 1 x
    2048.  Returns (the kernels' launches over the steps, the report)."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs as tconfigs
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step

    dev = torch.device("cuda", 0)
    full = tconfigs.get("rwkv6_7b")
    cfg = dataclasses.replace(full, n_layers=RWKV_TRAIN_LAYERS, n_groups=0)
    B, T = RWKV_TRAIN
    torch.empty(0, device=dev)  # a context before the memory statistics are read
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    by_design = dict(ls.launches_by_design)
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK), device=dev, seed=0)
    params = model.params()
    n_params = sum(p_.numel() for p_ in params.values())
    opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    walls, mets, bwd_ms = [], [], []
    for i in range(RWKV_TRAIN_STEPS):
        batch = make_batch_for(cfg, B, T, step=i, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with backward_events("_Rwkv") as rb_events:
            params, opt_state, met = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        bwd_ms.append(events_total_ms(rb_events))
        mets.append({k_: v_.item() for k_, v_ in met.items()})
    launched = counts()
    by_design = {d_: n_ - by_design[d_] for d_, n_ in ls.launches_by_design.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    losses = [m_["loss"] for m_ in mets]
    print(f"[24] rwkv6-7b at full width (d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {RWKV_TRAIN_LAYERS} of {full.n_layers} layers "
          f"({n_params / 1e9:.3f} B parameters, fp32 masters and AdamW state), batch {B} x {T}, "
          f"rec_chunk {TRAIN_REC_CHUNK}, kernel path: loss per step {[round(x_, 6) for x_ in losses]}, "
          f"grad norm {[round(m_['grad_norm'], 6) for m_ in mets]}; step wall ms {[round(w_, 1) for w_ in walls]} "
          f"(median after the first {steady:.1f} ms, {B * T / steady * 1e3:.1f} tokens/s); "
          f"torch.cuda.max_memory_allocated {peak:.2f} GB; the rwkv backward {[round(b_, 2) for b_ in bwd_ms]} "
          f"device ms a step (CUDA events around each of its {RWKV_TRAIN_LAYERS} calls a step, "
          f"{ls.rwkv_bwd_slices(B, cfg.n_heads, cfg.d_head, torch.cuda.get_device_properties(dev).multi_processor_count)} "
          f"row slices a head); launches {launched}, rwkv_scan by design {by_design}; {smi}")
    check(all(math.isfinite(v_) for m_ in mets for v_ in m_.values()), "rwkv6-7b: a metric is not finite")
    check(peak < 80.0, f"rwkv6-7b: peak memory {peak:.2f} GB")
    per_run = RWKV_TRAIN_LAYERS * RWKV_TRAIN_STEPS
    check(launched["rwkv_scan"] == per_run and launched["rwkv_scan_bwd"] == per_run
          and by_design["tc"] == per_run
          and not any(other_launches(launched, "rwkv_scan", "rwkv_scan_bwd").values())
          and adamw_updates(launched, cfg, "rwkv6-7b") == RWKV_TRAIN_STEPS,
          f"rwkv6-7b: launches {launched} (by design {by_design}) over {RWKV_TRAIN_STEPS} steps, "
          f"expected rwkv_scan (tc) and rwkv_scan_bwd {RWKV_TRAIN_LAYERS} times a step, one AdamW "
          f"update a step and nothing else")
    del opt_state, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()

    # one batch, no update.  (a) Each layer's forward: the scan's inputs
    # captured on the kernel path, the tensor-core kernel's y on them
    # against the exact per-token scan and the sub-chunked plain version.
    batch = make_batch_for(cfg, B, T, step=0, seed=0, device=dev)
    fwd = rwkv_layer_forwards(model, batch)
    # (b) bf16 as trained, the kernel path against the plain path
    # (wkv_chunked) and the kernel path with the exact per-token forward,
    # the rwkv backward timed per call: printed.  (c) The backward kernel
    # inside the step: the kernel path's forward with the backward through
    # the kernel and through ``rwkv_scan_bwd_plain``, the losses held equal
    # and the gradient norms printed.  (d) fp32 arithmetic on the same
    # weights (the per-token forward design), kernel path against plain
    # path, held.  (e) The bf16 paths, and (c)'s two backwards, at
    # ``RWKV_AGREE_LAYERS`` layers, held.
    reset_counts()
    paths = timed_paths(model, batch, ops._Rwkv, rec_chunk=TRAIN_REC_CHUNK)
    path_launches = paths.pop("launched")
    (lk, gk), (lp, gp) = paths["cuda"], paths["xla"]
    design = ls.rwkv_design
    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK)
    ls.rwkv_design = lambda *args_, **kw_: "per_token"
    try:
        le, ge = loss_and_grads(model, batch)
    finally:
        ls.rwkv_design = design
    print(f"[24] rwkv6-7b bf16 as trained, kernel path vs plain path (wkv_chunked), batch {B} x {T}, "
          f"no update: loss {lk:.6f} / {lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}), global grad norm "
          f"{gk:.6f} / {gp:.6f} (rel {abs(gk - gp) / abs(gp):.2e}); the kernel path with the exact "
          f"per-token forward: loss {le:.6f}, grad norm {ge:.6f} (rel {abs(ge - gp) / abs(gp):.2e} to the "
          f"plain path); printed, not held: the forwards' y agree to one bf16 rounding, and at "
          f"{RWKV_TRAIN_LAYERS} random bf16 layers the gradient norm parts between any two of them "
          f"(held at {RWKV_AGREE_LAYERS} layers below); forward+backward {paths['cuda_fb_ms']:.1f} "
          f"ms (kernel path, {paths['bwd_calls']} rwkv backward calls {paths['bwd_ms']:.1f} ms, "
          f"{paths['bwd_ms'] / max(paths['bwd_calls'], 1):.3f} ms a call, synchronized around each), "
          f"{paths['cuda_fb_free_ms']:.1f} ms without those synchronizations / {paths['xla_fb_ms']:.1f} ms "
          f"(plain path); launches {path_launches}; {smi}")
    check(path_launches["rwkv_scan_bwd"] == RWKV_TRAIN_LAYERS and paths["bwd_calls"] == RWKV_TRAIN_LAYERS,
          f"rwkv6-7b: one forward + backward launched rwkv_scan_bwd {path_launches['rwkv_scan_bwd']} "
          f"times in {paths['bwd_calls']} backward calls, expected {RWKV_TRAIN_LAYERS}")
    kernel_bwd = ls.rwkv_scan_bwd
    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK)
    ls.rwkv_scan_bwd = lambda *args_, interpret=False: ls.rwkv_scan_bwd_plain(*args_)
    try:
        ls_, gs_ = loss_and_grads(model, batch)
    finally:
        ls.rwkv_scan_bwd = kernel_bwd
    print(f"[24] rwkv6-7b bf16, the kernel path's forward, backward through the kernel vs through "
          f"rwkv_scan_bwd_plain: loss {lk:.6f} / {ls_:.6f} (equal, held), global grad norm {gk:.6f} / "
          f"{gs_:.6f} (rel {abs(gk - gs_) / abs(gs_):.2e}); printed, not held: at {RWKV_TRAIN_LAYERS} "
          f"random bf16 layers the norm turns on roundings (held at {RWKV_AGREE_LAYERS} layers below)")
    check(ls_ == lk, "rwkv6-7b: the forward changed with the backward it is paired with")
    model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    fp32 = {}
    for impl in ("cuda", "xla"):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=TRAIN_REC_CHUNK)
        fp32[impl] = loss_and_grads(model, batch)
        model.zero_grad(set_to_none=True)
        gc.collect()
        torch.cuda.empty_cache()
    model.cfg = cfg
    (fk, fgk), (fp, fgp) = fp32["cuda"], fp32["xla"]
    ok = abs(fk - fp) <= 1e-3 * abs(fp) and abs(fgk - fgp) <= 1e-2 * abs(fgp)
    print(f"[24] rwkv6-7b fp32 arithmetic on the same weights, kernel path vs plain path: loss "
          f"{fk:.6f} / {fp:.6f} (rel {abs(fk - fp) / abs(fp):.2e}, limit 1e-3), global grad norm "
          f"{fgk:.6f} / {fgp:.6f} (rel {abs(fgk - fgp) / abs(fgp):.2e}, limit 1e-2) {'ok' if ok else 'FAIL'}")
    check(ok, "rwkv6-7b: in fp32 the kernel path's loss or gradient norm disagrees with the plain path")
    report = {"layers": RWKV_TRAIN_LAYERS, "of_layers": full.n_layers, "parameters": n_params,
              "batch": [B, T], "rec_chunk": TRAIN_REC_CHUNK, "loss": losses, "step_ms": walls,
              "median_step_ms": steady, "tokens_per_s": B * T / steady * 1e3, "peak_gb": peak,
              "bwd_device_ms_per_step": bwd_ms,
              "forward_by_layer": fwd,
              "paths_bf16": {"loss": [lk, lp], "grad_norm": [gk, gp], "exact_forward": [le, ge],
                             "forward_backward_ms": [paths["cuda_fb_ms"], paths["xla_fb_ms"]],
                             "forward_backward_unsynchronized_ms": paths["cuda_fb_free_ms"],
                             "rwkv_backward_ms": paths["bwd_ms"], "rwkv_backward_calls": paths["bwd_calls"]},
              "backward_kernel_vs_plain_bf16": {"loss": [lk, ls_], "grad_norm": [gk, gs_]},
              "paths_fp32": {"loss": [fk, fp], "grad_norm": [fgk, fgp]}}
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the same training at RWKV_AGREE_LAYERS layers, kernel path
    # against plain path in bf16, held
    cfg = dataclasses.replace(full, n_layers=RWKV_AGREE_LAYERS, n_groups=0)
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK), device=dev, seed=0)
    params = model.params()
    opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    for i in range(RWKV_TRAIN_STEPS):
        params, opt_state, _ = step_fn(params, opt_state, make_batch_for(cfg, B, T, step=i, seed=0, device=dev))
    del opt_state, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    batch = make_batch_for(cfg, B, T, step=0, seed=0, device=dev)
    agree = {}
    for impl in ("cuda", "xla"):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=TRAIN_REC_CHUNK)
        agree[impl] = loss_and_grads(model, batch)
        model.zero_grad(set_to_none=True)
    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK)
    ls.rwkv_scan_bwd = lambda *args_, interpret=False: ls.rwkv_scan_bwd_plain(*args_)
    try:
        agree["plain_bwd"] = loss_and_grads(model, batch)
    finally:
        ls.rwkv_scan_bwd = kernel_bwd
    model.zero_grad(set_to_none=True)
    (ak, agk), (ap, agp), (ab, agb) = agree["cuda"], agree["xla"], agree["plain_bwd"]
    ok_b = ab == ak and abs(agk - agb) <= 1e-2 * abs(agb)
    print(f"[24] rwkv6-7b bf16 with {RWKV_AGREE_LAYERS} of {full.n_layers} layers, trained "
          f"{RWKV_TRAIN_STEPS} steps, the kernel path's forward, backward through the kernel vs through "
          f"rwkv_scan_bwd_plain: loss {ak:.6f} / {ab:.6f} (equal), global grad norm {agk:.6f} / {agb:.6f} "
          f"(rel {abs(agk - agb) / abs(agb):.2e}, limit 1e-2) {'ok' if ok_b else 'FAIL'}")
    check(ok_b, f"rwkv6-7b at {RWKV_AGREE_LAYERS} layers: the backward kernel disagrees with its plain "
                "version inside the step")
    ok = abs(ak - ap) <= 1e-3 * abs(ap) and abs(agk - agp) <= 1e-2 * abs(agp)
    print(f"[24] rwkv6-7b bf16 with {RWKV_AGREE_LAYERS} of {full.n_layers} layers at full width, trained "
          f"{RWKV_TRAIN_STEPS} steps the same way, kernel path vs plain path (wkv_chunked), batch {B} x {T}, "
          f"no update: loss {ak:.6f} / {ap:.6f} (rel {abs(ak - ap) / abs(ap):.2e}, limit 1e-3), global grad "
          f"norm {agk:.6f} / {agp:.6f} (rel {abs(agk - agp) / abs(agp):.2e}, limit 1e-2) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"rwkv6-7b at {RWKV_AGREE_LAYERS} layers: in bf16 the kernel path's loss or gradient norm "
              "disagrees with the plain path")
    report["paths_bf16_agree"] = {"layers": RWKV_AGREE_LAYERS, "loss": [ak, ap], "grad_norm": [agk, agp]}
    report["backward_kernel_vs_plain_bf16_agree"] = {"layers": RWKV_AGREE_LAYERS, "loss": [ak, ab],
                                                     "grad_norm": [agk, agb]}
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launched, report


def rwkv_layer_forwards(model, batch) -> dict:
    """Phase 24 (a): each layer's ``rwkv_scan`` inputs from one forward on
    the kernel path; on each, the tensor-core kernel's y against the exact
    per-token scan in fp32 (||y - exact|| / ||exact|| at ``RWKV_FWD_REL``,
    beside the exact values rounded to bf16) and against the sub-chunked
    plain version rounded to bf16 (``TOL``, as serving holds it).  These
    launches are checks, made after the main path's counts were read."""
    import torch

    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.models import ExecConfig
    from repro_torch.train import make_loss_fn

    captured, scan = [], ops.rwkv_scan

    def capture(*args_, **kw_):
        captured.append([t_.detach().clone() for t_ in args_])
        return scan(*args_, **kw_)

    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=TRAIN_REC_CHUNK)
    ops.rwkv_scan = capture
    try:
        with torch.no_grad():
            make_loss_fn(model)(model.params(), batch)
    finally:
        ops.rwkv_scan = scan
    tol = TOL["rwkv_scan"]["bfloat16"]
    rel, rounded, worst, designs = [], [], [], set()
    for args_ in captured:
        before = dict(ls.launches_by_design)
        y = ls.rwkv_scan_chunked(*args_, chunk=TRAIN_REC_CHUNK)[0]
        designs |= {d_ for d_, n_ in ls.launches_by_design.items() if n_ > before[d_]}
        f32 = (*(t_.float() for t_ in args_[:3]), *args_[3:])
        exact = ref.rwkv_scan_ref(*f32)[0]
        rel.append(bwd_rel(y, exact))
        rounded.append(bwd_rel(exact.to(y.dtype), exact))
        sub = ls.rwkv_scan_subchunk_plain(*args_)[0].float()
        worst.append(((y.float() - sub).abs() / (tol + tol * sub.abs())).max().item())
        del y, exact, sub, f32
    del captured
    torch.cuda.empty_cache()
    ok = (len(rel) == RWKV_TRAIN_LAYERS and designs == {"tc"} and max(rel) <= RWKV_FWD_REL
          and max(worst) <= 1.0)
    print(f"[24] rwkv6-7b bf16, each layer's rwkv_scan inputs from the kernel path, the {sorted(designs)} "
          f"kernel's y against the exact per-token scan in fp32, ||y - exact|| / ||exact|| by layer "
          f"{[float(f'{x_:.3e}') for x_ in rel]} (max {max(rel):.3e}, limit {RWKV_FWD_REL:g}; the exact "
          f"values rounded to bf16: max {max(rounded):.3e}); against the sub-chunked plain version, worst "
          f"err/limit by layer {[round(x_, 3) for x_ in worst]} (allclose(atol={tol:g}, rtol={tol:g})) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "rwkv6-7b: the tensor-core forward disagrees with the exact scan on a trained layer's inputs")
    return {"rel_to_exact": rel, "exact_rounded_rel": rounded, "worst_err_over_limit": worst}


def flash_per_forward(cfg) -> tuple:
    """(causal, non-causal) flash launches a training forward pass makes on
    the kernel path: each self-attention layer without a window, causal
    (``attn`` and ``cross`` blocks), and each encoder layer, non-causal."""
    causal = sum(1 for kind in cfg.pattern if kind in ("attn", "cross")) if cfg.window == 0 else 0
    return causal, cfg.enc_layers


def family_train_phases(out: Path, smi: str) -> tuple:
    """Phases 22-23: seamless-m4t-large-v2 at full width and depth through
    ``TrainJob`` and moonshot-v1-16b-a3b at full width with 2 of 48 layers
    through ``make_train_step``, both on the flash kernel and its backward
    kernel (the seamless encoder non-causal at head dim 64, every decoder
    self-attention causal), and the cross attention's scores under autograd
    in the bf16 product form; seamless also at batch 3 for its peak, where
    ``SEAMLESS_TRAIN`` holds another batch.
    Returns (the kernels' launch counts over the training runs, a report)."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs as tconfigs
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import ExecConfig, TrainModel, blocks, moe
    from repro_torch.optim import AdamW, cosine_schedule, global_norm
    from repro_torch.runtime import TrainJob
    from repro_torch.train import make_loss_fn, make_train_step

    dev = torch.device("cuda", 0)
    launched_total = {n: 0 for n in COUNTERS}
    report = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def flash_spy():
        """Wrap ``ops.flash_attention`` to record each call's ``causal``;
        returns (the flags, a function that restores the wrapper)."""
        flags, real = [], ops.flash_attention

        def spy(*args_, **kw_):
            flags.append(kw_["causal"])
            return real(*args_, **kw_)

        ops.flash_attention = spy
        return flags, lambda: setattr(ops, "flash_attention", real)

    def paths_agree(phase, arch, model, batch):
        """Loss and global gradient norm of one forward/backward on the
        kernel path and on the plain path (``attn_impl="xla"``), no update."""
        got = {}
        for impl in ("cuda", "xla"):
            model.exec_cfg = dataclasses.replace(model.exec_cfg, attn_impl=impl)
            model.zero_grad(set_to_none=True)
            loss_, _ = make_loss_fn(model)(model.params(), batch)
            loss_.backward()
            got[impl] = (loss_.item(), global_norm([p_.grad for p_ in model.params().values()]).item())
            model.zero_grad(set_to_none=True)
            del loss_
            free()
        model.exec_cfg = dataclasses.replace(model.exec_cfg, attn_impl="cuda")
        (lk, gk), (lp, gp) = got["cuda"], got["xla"]
        ok = abs(lk - lp) <= 1e-3 * abs(lp) and abs(gk - gp) <= 1e-2 * abs(gp)
        print(f"[{phase}] {arch} kernel path vs plain path, one batch, no update: loss {lk:.6f} / "
              f"{lp:.6f} (rel {abs(lk - lp) / abs(lp):.2e}, limit 1e-3), global grad norm {gk:.6f} / "
              f"{gp:.6f} (rel {abs(gk - gp) / abs(gp):.2e}, limit 1e-2) {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch}: the kernel path's loss or gradient norm disagrees with the plain path")
        return {"loss": [lk, lp], "grad_norm": [gk, gp]}

    # 22. seamless-m4t-large-v2 at full width and depth through TrainJob:
    # frames of 4096 as served, the largest batch under 80 GB
    cfg = tconfigs.get(SEAMLESS)
    causal, noncausal = flash_per_forward(cfg)
    free()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    wgmma0, bwd0 = fa.launches_by_design["wgmma"], fa.launches_by_design["bwd_wgmma"]
    per_step, bwd_per_step = [], []
    flags, restore = flash_spy()

    def on_step(step_, metrics_):
        per_step.append(fa.launches - sum(per_step))
        bwd_per_step.append(fa.bwd_launches - sum(bwd_per_step))

    job = TrainJob(arch=SEAMLESS, tiny=False, steps=SEAMLESS_TRAIN_STEPS, global_batch=SEAMLESS_TRAIN[0],
                   seq_len=SEAMLESS_TRAIN[1], warmup=0, seed=0, device="cuda")
    try:
        with backward_events() as fb_events:
            t0 = time.perf_counter()
            hist = job.run(on_step=on_step)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        bwd_ms = events_total_ms(fb_events) / len(per_step)
    finally:
        restore()
    launched = counts()
    for n_, c_ in launched.items():
        launched_total[n_] += c_
    wgmma = fa.launches_by_design["wgmma"] - wgmma0
    bwd_wgmma = fa.launches_by_design["bwd_wgmma"] - bwd0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del job
    free()
    losses, times_ = hist["loss"], hist["step_time"]
    med = sorted(times_)[len(times_) // 2]
    B, S = SEAMLESS_TRAIN
    print(f"[22] {SEAMLESS} TrainJob at full width and depth ({cfg.enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, frames ({B}, {cfg.ctx_tokens}, {cfg.d_model}), batch {B} x {S} tokens): "
          f"{len(losses)} steps in {wall:.1f}s; loss per step {[round(x_, 4) for x_ in losses]}; step wall ms "
          f"{[round(t_ * 1e3, 1) for t_ in times_]}, median {med * 1e3:.1f} ms, {B * S / med:.1f} tokens/s; "
          f"torch.cuda.max_memory_allocated {peak:.2f} GB; flash launches per step {per_step} "
          f"({wgmma} wgmma; {sum(flags)} causal, {len(flags) - sum(flags)} non-causal; the model implies "
          f"{causal} causal + {noncausal} non-causal a step), flash backward launches per step "
          f"{bwd_per_step} ({bwd_wgmma} wgmma), the flash backward {bwd_ms:.2f} device ms a step (CUDA events "
          f"around each call); launches {launched}; {smi}")
    check(all(math.isfinite(x_) for x_ in losses) and losses[-1] < losses[0],
          f"{SEAMLESS}: the loss is not finite and falling: {losses}")
    check(per_step == [causal + noncausal] * len(losses) and wgmma == sum(per_step)
          and sum(flags) == causal * len(losses) and len(flags) == sum(per_step),
          f"{SEAMLESS}: flash launches per step {per_step} ({wgmma} wgmma, {sum(flags)} causal), "
          f"expected {causal} causal + {noncausal} non-causal wgmma launches a step")
    check(bwd_per_step == per_step and bwd_wgmma == sum(bwd_per_step),
          f"{SEAMLESS}: flash backward launches per step {bwd_per_step} ({bwd_wgmma} wgmma), expected one "
          f"of the wgmma design per forward launch {per_step}")
    check(not any(other_launches(launched, "flash_attention", "flash_attention_bwd").values())
          and adamw_updates(launched, cfg, SEAMLESS) == len(losses),
          f"{SEAMLESS}: unexpected launches {launched}, expected one AdamW update a step")
    check(peak < 80.0, f"{SEAMLESS}: peak memory {peak:.2f} GB")
    batch3 = None
    if B != 3:  # the batch the oracle backward held it to: its peak now
        torch.cuda.reset_peak_memory_stats(dev)
        job = TrainJob(arch=SEAMLESS, tiny=False, steps=2, global_batch=3, seq_len=S, warmup=0, seed=0,
                       device="cuda")
        hist3 = job.run()
        batch3 = {"peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                  "step_ms": [t_ * 1e3 for t_ in hist3["step_time"]]}
        del job
        free()
        print(f"[22] {SEAMLESS} TrainJob at batch 3 x {S} (2 steps, for the peak): step wall ms "
              f"{[round(t_, 1) for t_ in batch3['step_ms']]}, torch.cuda.max_memory_allocated "
              f"{batch3['peak_gb']:.2f} GB; {smi}")
        check(batch3["peak_gb"] < peak, f"{SEAMLESS}: batch 3 peaks at {batch3['peak_gb']:.2f} GB, not under "
              f"batch {B}'s {peak:.2f} GB")
    # the plain path keeps every encoder layer's (B, 16, 4096, 4096) fp32
    # softmax for the backward: 3.2 GB a layer and sequence in all, so the
    # paths are held on one sequence
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
    batch = make_batch_for(cfg, 1, S, step=0, seed=0, device=dev)
    check(batch["frames"].shape == (1, cfg.ctx_tokens, cfg.d_model) and batch["frames"].is_cuda
          and batch["frames"].dtype == torch.float32,
          f"{SEAMLESS}: frames {tuple(batch['frames'].shape)} {batch['frames'].dtype} on "
          f"{batch['frames'].device}")
    paths = paths_agree(22, SEAMLESS, model, batch)
    report[SEAMLESS] = {"batch": [B, S], "loss": losses, "step_ms": [t_ * 1e3 for t_ in times_],
                        "median_step_ms": med * 1e3, "tokens_per_s": B * S / med, "peak_gb": peak,
                        "flash_per_step": per_step, "wgmma": wgmma, "paths": paths,
                        "flash_bwd_per_step": bwd_per_step, "bwd_wgmma": bwd_wgmma,
                        "flash_bwd_device_ms_per_step": bwd_ms, "batch3": batch3,
                        "params": sum(p_.numel() for p_ in model.params().values())}
    del model, batch
    free()

    # 23. moonshot-v1-16b-a3b at full width, 2 of 48 layers, batch 1 x 2048
    # through make_train_step: 64 experts, top-6, the capacity branch
    cfg = dataclasses.replace(tconfigs.get(MOONSHOT), n_layers=MOONSHOT_TRAIN_LAYERS, n_groups=0)
    causal, noncausal = flash_per_forward(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    wgmma0, bwd0 = fa.launches_by_design["wgmma"], fa.launches_by_design["bwd_wgmma"]
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
    params = model.params()
    n_params = sum(p_.numel() for p_ in params.values())
    opt = AdamW(lr=cosine_schedule(1e-3, 0, 50))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    stats, real_moe = [], blocks.moe_apply

    def moe_spy(cfg_, p_, x_):
        r_ = moe.route(cfg_, p_, x_.reshape(-1, x_.shape[-1]))
        stats.append((x_.shape[0] * x_.shape[1], r_["capacity"], int((~r_["keep"]).sum())))
        return real_moe(cfg_, p_, x_)

    flags, restore = flash_spy()
    blocks.moe_apply = moe_spy
    walls, mets, per_step, bwd_per_step = [], [], [], []
    try:
        with backward_events() as fb_events:
            for i in range(MOONSHOT_TRAIN_STEPS):
                batch = make_batch_for(cfg, 1, QWEN_SEQ, step=i, seed=0, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt_state, met = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                mets.append({k_: v_.item() for k_, v_ in met.items()})
                per_step.append(fa.launches - sum(per_step))
                bwd_per_step.append(fa.bwd_launches - sum(bwd_per_step))
        bwd_ms = events_total_ms(fb_events) / len(per_step)
    finally:
        restore()
        blocks.moe_apply = real_moe
    launched = counts()
    for n_, c_ in launched.items():
        launched_total[n_] += c_
    wgmma = fa.launches_by_design["wgmma"] - wgmma0
    bwd_wgmma = fa.launches_by_design["bwd_wgmma"] - bwd0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [m_["loss"] for m_ in mets]
    T, K = stats[0][0], cfg.top_k
    first = stats[:cfg.n_layers]
    print(f"[23] {MOONSHOT} {cfg.n_layers} of 48 layers at full width (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{K}, d_ff_expert {cfg.d_ff_expert}; {n_params / 1e9:.3f} B "
          f"parameters), batch 1 x {QWEN_SEQ} through make_train_step: loss per step "
          f"{[round(x_, 4) for x_ in losses]}, grad norm {[round(m_['grad_norm'], 4) for m_ in mets]}; "
          f"step wall ms {[round(w_, 1) for w_ in walls]}, {QWEN_SEQ / (sorted(walls)[len(walls) // 2] / 1e3):.1f} "
          f"tokens/s (median step); torch.cuda.max_memory_allocated {peak:.2f} GB; flash launches per "
          f"step {per_step} ({wgmma} wgmma, causal {sorted(set(flags))}), flash backward launches per step "
          f"{bwd_per_step} ({bwd_wgmma} wgmma), the flash backward {bwd_ms:.3f} device ms a step; MoE dispatch: "
          f"T = {T} tokens, "
          f"T*K = {T * K} assignments (> {moe.DROP_FREE_ASSIGNMENTS}: the capacity branch), C = "
          f"{sorted({c_ for _, c_, _ in stats})} slots per expert, dropped per layer in step 1 "
          f"{[d_ for _, _, d_ in first]} of {T * K}; launches {launched}; {smi}")
    check(all(math.isfinite(v_) for m_ in mets for v_ in m_.values()) and losses[-1] < losses[0],
          f"{MOONSHOT}: the loss is not finite and falling: {losses}")
    check(per_step == [causal + noncausal] * len(losses) and wgmma == sum(per_step) and all(flags),
          f"{MOONSHOT}: flash launches per step {per_step} ({wgmma} wgmma, causal {set(flags)}), "
          f"expected {causal} causal wgmma launches a step")
    check(T * K > moe.DROP_FREE_ASSIGNMENTS and all(c_ == moe.capacity(cfg, T) for _, c_, _ in stats),
          f"{MOONSHOT}: training did not take the capacity branch: {stats[:2]}")
    check(bwd_per_step == per_step and bwd_wgmma == sum(bwd_per_step),
          f"{MOONSHOT}: flash backward launches per step {bwd_per_step} ({bwd_wgmma} wgmma), expected one of "
          f"the wgmma design per forward launch {per_step}")
    check(not any(other_launches(launched, "flash_attention", "flash_attention_bwd").values())
          and adamw_updates(launched, cfg, MOONSHOT) == len(losses),
          f"{MOONSHOT}: unexpected launches {launched}, expected one AdamW update a step")
    check(peak < 80.0, f"{MOONSHOT}: peak memory {peak:.2f} GB")
    del opt_state, step_fn, opt, params
    free()
    batch = make_batch_for(cfg, 1, QWEN_SEQ, step=0, seed=0, device=dev)
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
    paths = paths_agree(23, MOONSHOT, model, batch)
    report[MOONSHOT] = {"layers": cfg.n_layers, "params": n_params, "loss": losses, "step_ms": walls,
                        "peak_gb": peak, "flash_per_step": per_step, "wgmma": wgmma, "paths": paths,
                        "flash_bwd_per_step": bwd_per_step, "bwd_wgmma": bwd_wgmma,
                        "flash_bwd_device_ms_per_step": bwd_ms,
                        "capacity": stats[0][1], "drops_step1": [d_ for _, _, d_ in first]}
    del model, batch
    free()
    report["flash_launches"] = {SEAMLESS: report[SEAMLESS]["wgmma"], MOONSHOT: report[MOONSHOT]["wgmma"]}
    report["flash_bwd_launches"] = {SEAMLESS: report[SEAMLESS]["bwd_wgmma"], MOONSHOT: report[MOONSHOT]["bwd_wgmma"]}
    return launched_total, report



#: phase 19's subprocesses (host work, no card): the calibration cell
#: counted at world 1 under remat none and full, on the flash kernel's cost
#: surrogate with the kernel's FLOPs added back; the production cells on
#: the (16, 16) and (2, 16, 16) fake meshes; pretune --launch --cost
#: runtime twice; the hill climb
_DRYRUN_CALIB = """
import dataclasses, json
from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import costing, dryrun
shape = ShapeSpec(*{shape!r})
cut = dict(n_layers={layers}, n_groups=0)
out = {{}}
for remat in ("none", "full"):
    out[remat] = dryrun.run_cell("qwen2_7b", shape, cfg_overrides=cut, probes=False,
                                 mesh_spec=((1, 1), ("data", "model")), verbose=True,
                                 exec_overrides=dict(attn_impl="flashcost", remat=remat))
    out[remat]["flash_flops"] = costing.attention_traffic(
        dataclasses.replace(configs.get("qwen2_7b"), **cut), shape, 1, 1)["flash_flops"]
print("CALIB " + json.dumps(out))
"""
_DRYRUN_CELLS = """
from repro_torch.launch import dryrun
assert dryrun.main(["--all", "--out", {out!r}]) == 0
assert dryrun.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--multi-pod",
                    "--out", {out!r}]) == 0
"""
#: phase 19's production cells, which must count (``--all`` counts them
#: with the other 30 runnable cells; the last on the (2, 16, 16) mesh)
DRYRUN_NAMED = [("qwen2_7b", "train_4k", False), ("recurrentgemma_2b", "train_4k", False),
                ("moonshot_v1_16b_a3b", "train_4k", False), ("qwen2_7b", "decode_32k", False),
                ("rwkv6_7b", "long_500k", False), ("qwen2_7b", "decode_32k", True)]
_DRYRUN_PRETUNE = """
from repro_torch.tuning import pretune
for run in (1, 2):
    print("PRETUNE RUN", run, flush=True)
    rc = pretune.main(["--launch", "--cost", "runtime", "--smoke", "--devices", "8",
                       "--db", {db!r}])
    assert rc == 0, rc
"""


def start_dryruns(out: Path) -> dict:
    """Phase 19's subprocesses, started together (host work, no card):
    name -> (Popen, the file its output goes to)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for name in ("dryrun_cells.jsonl", "pretune_dryrun.json", "pretune_dryrun.json.journal",
                 "hillclimb.jsonl"):
        (out / name).unlink(missing_ok=True)
    programs = {
        "calib": ["-c", _DRYRUN_CALIB.format(shape=DRYRUN_SHAPE, layers=QWEN_LAYERS)],
        "cells": ["-c", _DRYRUN_CELLS.format(out=str(out / "dryrun_cells.jsonl"))],
        "pretune": ["-c", _DRYRUN_PRETUNE.format(db=str(out / "pretune_dryrun.json"))],
        "hillclimb": ["-m", "repro_torch.launch.hillclimb", "--arch", "qwen2_7b", "--shape",
                      "train_4k", "--budget", "6", "--out", str(out / "hillclimb.jsonl")],
    }
    procs = {}
    for name, argv in programs.items():
        log = open(out / f"dryrun_{name}.log", "w")
        procs[name] = (subprocess.Popen([sys.executable, *argv], stdout=log,
                                        stderr=subprocess.STDOUT, cwd=str(ROOT), env=env),
                       out / f"dryrun_{name}.log", log)
    return procs


def finish_dryrun(procs: dict, name: str, deadline: float) -> str:
    """Wait for one of phase 19's subprocesses (killed at ``deadline``);
    its output, which must end in exit 0."""
    proc, path, log = procs[name]
    try:
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    log.close()
    text = path.read_text()
    if proc.returncode != 0:
        print(text[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"[19] the dry run's {name} process failed (exit {proc.returncode})")
    return text


def stop_dryruns(procs: dict) -> None:
    for proc, _, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_phase(out: Path, smi: str, procs: dict, deadline: float, q_cfg, measured: dict,
                 real_args: int) -> dict:
    """Phase 19's checks of the dry run's subprocesses (``start_dryruns``):
    the calibration cell's model against ``measured`` (remat -> (ms a step,
    peak bytes) on the card) and the card's argument bytes, the production
    cells, pretune twice and the hill climb.  Returns the report."""
    from repro_torch.core.costs import H100_SXM

    text = finish_dryrun(procs, "calib", deadline)
    calib = json.loads(next(ln for ln in text.splitlines() if ln.startswith("CALIB "))[6:])
    cal_report = {}
    for remat, (ms, peak) in measured.items():
        r = calib[remat]
        rf, mem = r["roofline"], r["memory"]
        flops = rf["flops"] + r["flash_flops"]
        compute = flops / H100_SXM.peak_for(q_cfg.compute_dtype)
        bound = max(compute, rf["memory_s"], rf["collective_s"])
        ratio = ms / (bound * 1e3)
        eq = mem["argument_bytes"] == real_args
        print(f"[19] calibration, qwen2-7b {QWEN_LAYERS} layers, 1 x {QWEN_SEQ}, remat {remat}, the "
              f"flash kernel on the card, its cost surrogate in the dry run (world 1, meta): modelled "
              f"(H100_SXM data sheet) compute {compute * 1e3:.3f} ms ({flops / 1e12:.4f} TFLOP = "
              f"{rf['flops'] / 1e12:.4f} counted + {r['flash_flops'] / 1e12:.4f} flash added back), "
              f"memory {rf['memory_s'] * 1e3:.3f} ms ({rf['bytes_accessed'] / 1e9:.2f} GB, eager "
              f"unfused), bound {bound * 1e3:.3f} ms; measured {ms:.2f} ms a step (median of steps 2-"
              f"{DP_STEPS}) = {ratio:.3f} x the bound; argument bytes modelled {mem['argument_bytes']} "
              f"vs the card's params + AdamW state + batch {real_args}: equal {eq} (both hold the "
              f"batch as int64; the JAX package's int32 batch would be {2 * QWEN_SEQ * 4} bytes less); "
              f"peak modelled {mem['peak_bytes'] / 1e9:.3f} GB / measured {peak / 1e9:.3f} GB = "
              f"{mem['peak_bytes'] / peak:.3f}; counted in {r['elapsed_s']}s; {smi}")
        check(eq, f"remat {remat}: modelled argument bytes {mem['argument_bytes']} != the card's "
                  f"{real_args}")
        cal_report[remat] = {"measured_ms": ms, "measured_peak": peak, "modelled_compute_s": compute,
                             "modelled_memory_s": rf["memory_s"], "modelled_bound_s": bound,
                             "ratio": ratio, "modelled_args": mem["argument_bytes"],
                             "real_args": real_args, "modelled_peak": mem["peak_bytes"],
                             "counted_flops": rf["flops"], "flash_flops": r["flash_flops"],
                             "bytes": rf["bytes_accessed"]}
    print(f"[19] remat full against none: measured {measured['full'][0] / measured['none'][0]:.3f}x "
          f"the step time at {measured['full'][1] / measured['none'][1]:.3f}x the peak; modelled "
          f"{cal_report['full']['modelled_bound_s'] / cal_report['none']['modelled_bound_s']:.3f}x "
          f"the bound at {cal_report['full']['modelled_peak'] / cal_report['none']['modelled_peak']:.3f}x "
          f"the peak; {smi}")
    report = {"dryrun_calibration": cal_report}

    # the 40 cells (--all) and the multi-pod cell, each counted from 2- and
    # 4-group variants
    finish_dryrun(procs, "cells", deadline)
    cells = [json.loads(ln) for ln in (out / "dryrun_cells.jsonl").read_text().splitlines()]
    for r in cells:
        if r["status"] == "skipped":
            continue
        rf = r.get("roofline") or {}
        print(f"[19] dryrun {r['arch']} x {r['shape']} {r.get('mesh')}: status {r['status']}, "
              f"elapsed_s {r.get('elapsed_s')}, modelled (H100_SXM) compute {rf.get('compute_s', 0) * 1e3:.1f} "
              f"ms | memory {rf.get('memory_s', 0) * 1e3:.1f} ms | collective "
              f"{rf.get('collective_s', 0) * 1e3:.1f} ms -> {rf.get('dominant')}, args "
              f"{r.get('memory', {}).get('argument_bytes', 0) / 1e9:.2f} GB, peak "
              f"{r.get('memory', {}).get('peak_bytes', 0) / 1e9:.2f} GB a rank, useful-flops ratio "
              f"{r.get('useful_flops_ratio', 0):.3f}")
    status = [r["status"] for r in cells[:40]]
    print(f"[19] dryrun --all: {len(status)} cells, {status.count('ok')} ok, "
          f"{status.count('skipped')} skipped, {status.count('error')} errors, in "
          f"{sum(r.get('elapsed_s', 0) for r in cells[:40]):.1f}s of counting")
    check((len(status), status.count("ok"), status.count("skipped")) == (40, 32, 8),
          "the dry run's 40 cells did not end 32 ok, 8 skipped")
    got = {(r["arch"], r["shape"], r["multi_pod"]): r["status"] for r in cells}
    check(len(cells) == 41 and all(got.get(c) == "ok" for c in DRYRUN_NAMED),
          f"the dry run's production cells: {[(c, got.get(c)) for c in DRYRUN_NAMED]}")
    report["dryrun_cells"] = cells

    # pretune --launch --cost runtime twice: 3 searched, then 3 exact hits
    text = finish_dryrun(procs, "pretune", deadline)
    runs = text.split("PRETUNE RUN 2")
    check(len(runs) == 2, "pretune --launch --cost runtime did not run twice")
    for run, (part, want) in enumerate(zip(runs, ("(0 exact hits, 3 searched)",
                                                   "(3 exact hits, 0 searched)")), 1):
        for line in part.splitlines():
            if line.startswith("pretune") or line.strip().startswith("launch/"):
                print(f"[19] pretune --launch --cost runtime run {run}: {line.strip()}")
        check(f"3 launch contexts tuned {want}" in part,
              f"pretune --launch --cost runtime run {run} did not report {want}")
        for line in part.splitlines():
            m_ = re.search(r"cost=([0-9.eE+-]+)s default=.* default_cost=([0-9.eE+-]+)s", line)
            if m_:
                check(float(m_.group(1)) <= float(m_.group(2)),
                      f"a committed launch point is worse than its default: {line.strip()}")

    # the hill climb over the execution knobs of qwen2-7b train_4k
    text = finish_dryrun(procs, "hillclimb", deadline)
    hc = [ln for ln in text.splitlines() if ln.startswith("[hc]")]
    for line in hc:
        print(f"[19] hillclimb --arch qwen2_7b --shape train_4k --budget 6: {line}")
    check(any(ln.startswith("[hc] best:") for ln in hc), "the hill climb found no best point")
    return report


def parallel_phases(out: Path, smi: str) -> dict:
    """Phases 16-17 and 19 (``main`` runs this in a child process:
    ``--parallel-phases``): the device-pinned fleet race on the matmul
    kernel, then the collectives, the compressed data-parallel step and the
    pipeline on a one-rank NCCL group; then the launch dry run, whose host
    work runs in subprocesses from the start, and its calibration on the
    card.  Returns the kernels' launch counts over those main paths."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out.mkdir(parents=True, exist_ok=True)
    # phase 19's host work starts now, beside the card's phases 16-17
    dry_deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    procs = start_dryruns(out)
    try:
        return _parallel_phases(out, smi, procs, dry_deadline)
    finally:
        stop_dryruns(procs)


def _parallel_phases(out: Path, smi: str, procs: dict, dry_deadline: float) -> dict:
    import dataclasses
    import functools
    import gc
    import socket
    import statistics
    import threading

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs as tconfigs
    from repro_torch.core import CSA, NelderMead, RandomSearch
    from repro_torch.core.costs import H100_SXM
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotuned import exec_cache, get_spec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW, cosine_schedule, tree_leaves
    from repro_torch.parallel.collectives import (chunked_psum, int8_psum, make_compressed_dp_step,
                                                  topk_psum, wire_bytes)
    from repro_torch.parallel.devices import local_device_pool
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.train import make_loss_fn, make_train_step
    from repro_torch.tuning.fleet import ShardedPortfolio, device_bound_measure

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    launched = {n: 0 for n in COUNTERS}
    report: dict = {}

    def add(counts_):
        for n_, c_ in counts_.items():
            launched[n_] += c_

    def events_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # 16. the device-pinned fleet: a ShardedPortfolio race over the matmul
    # tiles, each member measuring on its slot's card, in its worker thread
    slots = local_device_pool(FLEET_SLOTS, cache=exec_cache())
    print(f"[16] local_device_pool({FLEET_SLOTS}): {', '.join(map(str, slots))} "
          f"({torch.cuda.device_count()} card(s); {smi})")
    check(all(s_.device == dev for s_ in slots), f"slots not all on {dev}: {slots}")
    M, K, N = MM_SHAPE
    a = (torch.randn((M, K), generator=gen, device=dev)).to(torch.bfloat16)
    b = (torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    spec = get_spec("matmul")
    space = spec.space(a, b)
    dim = len(space.dims)
    members = [CSA(dim, num_opt=3, max_iter=6, seed=0), CSA(dim, num_opt=3, max_iter=6, seed=1),
               RandomSearch(dim, max_iter=18, seed=2), NelderMead(dim, max_iter=18, seed=3)]
    card_locks = {s_.device: threading.Lock() for s_ in slots}  # one timed region per card at a time
    pinned = []  # (member, thread, current card, slot card, output card) per measurement

    def measure(i, points):
        slot = slots[i % len(slots)]
        costs = []
        for z in points:
            knobs = space.decode(z)
            try:
                spec.check(a, b, interpret=False, **knobs)
            except ValueError:
                costs.append(float("inf"))
                continue
            fn = slot.cache.get_or_build(("fleet_matmul", tuple(sorted(knobs.items()))),
                                         lambda: functools.partial(ops.matmul, **knobs))
            with card_locks[slot.device]:
                got = fn(a, b)
                pinned.append((i, threading.get_ident(), torch.cuda.current_device(),
                               slot.device.index, got.device.index))
                costs.append(events_ms(lambda: fn(a, b), 3) * 1e-3)
        return costs

    reset_counts()
    fleet = ShardedPortfolio(members, rung=4)
    res = fleet.run(device_bound_measure(measure, slots))
    fleet_launches = counts()
    add(fleet_launches)
    best = space.decode(res.best_x)
    threads = {t_ for _, t_, _, _, _ in pinned}
    on_slot = all(cur == want == outd for _, _, cur, want, outd in pinned)
    print(f"[16] ShardedPortfolio race, matmul bf16 {M}x{K}x{N} (qwen2-7b FFN), {len(members)} members "
          f"(CSA x2, random, Nelder-Mead) pinned by device_bound_measure: wall {res.wall_s:.2f}s, "
          f"{res.spent} measured, member bests ms "
          f"{[round(c_ * 1e3, 4) if math.isfinite(c_) else None for c_ in res.member_bests]}, "
          f"survivors {res.survivors}, winner {best} at {res.best_cost * 1e3:.4f} ms; "
          f"{len(pinned)} measurements on {len(threads)} worker threads, each on its slot's card "
          f"(current device == slot device == output device): {on_slot}; launches {fleet_launches}; {smi}")
    check(on_slot and pinned, "a fleet measurement ran off its slot's card")
    check(math.isfinite(res.best_cost) and fleet_launches["matmul"] > 0,
          f"the race found no legal tile: {res.best_cost} {fleet_launches}")
    # the winner against its plain version (a check, after the counts were read)
    got, want = ops.matmul(a, b, **best), mm.matmul_plain(a, b, **best)
    tol = TOL["matmul"]["bfloat16"]
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    print(f"[16] the winner {best} against matmul_plain: max_abs_err={err:.3e} "
          f"allclose(atol={tol:g}, rtol={tol:g}) {'ok' if ok else 'FAIL'}; {smi}")
    check(ok, "the fleet's winning matmul tile disagrees with its plain version")
    report["fleet"] = {"wall_s": res.wall_s, "spent": res.spent, "member_bests_s": res.member_bests,
                       "survivors": res.survivors, "best": best, "best_s": res.best_cost,
                       "measurements": len(pinned), "threads": len(threads), "max_abs_err": err}
    del a, b, got, want, fleet, members
    gc.collect()
    torch.cuda.empty_cache()

    # 17. a one-rank NCCL group and a ("data",) mesh
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        group = mesh.get_group("data")
        print(f"[17] process group: {dist.get_backend()} world {dist.get_world_size()}, mesh {mesh}")
        g = torch.randn((MM_SHAPE[1], MM_SHAPE[2]), generator=gen, device=dev) * 1e-3
        whole = g.clone()
        dist.all_reduce(whole, group=group)
        r8 = int8_psum(g, group)
        amax = g.abs().max()
        scale = (torch.clamp(amax, min=1e-12) / 127.0).item()  # the fp32 scale int8_psum uses
        # within scale/2, up to the fp32 rounding of the divide and the
        # dequantizing multiply (two ulps of the largest |g|)
        limit8 = scale / 2 + 2 * amax.item() * 2.0 ** -23
        err8 = (r8 - g).abs().max().item()
        rk, ek = topk_psum(g, group, 0.01, torch.zeros_like(g))
        kept = int((rk != 0).sum().item())
        rc = chunked_psum(g, group, DP_CHUNK_BYTES)
        t = {"all_reduce": events_ms(lambda: dist.all_reduce(g.clone(), group=group), 5),
             "int8": events_ms(lambda: int8_psum(g, group), 5),
             "topk": events_ms(lambda: topk_psum(g, group, 0.01, torch.zeros_like(g)), 5),
             "chunked": events_ms(lambda: chunked_psum(g, group, DP_CHUNK_BYTES), 5)}
        ok8 = err8 <= limit8
        okk = torch.equal(rk + ek, g) and kept >= int(g.numel() * 0.01)
        okc = torch.equal(rc, whole)
        print(f"[17] collectives on a qwen2-7b FFN gradient {tuple(g.shape)} fp32, one rank: "
              f"int8_psum max|r-g| {err8:.6e} <= scale/2 + 2 ulp(max|g|) {limit8:.6e} (scale/2 "
              f"{scale / 2:.6e}) {'ok' if ok8 else 'FAIL'}; "
              f"topk_psum (k_ratio 0.01) kept {kept} of {g.numel()}, sparse + residual == g "
              f"{'ok' if okk else 'FAIL'}; chunked_psum ({DP_CHUNK_BYTES >> 20} MB chunks) bit-equal to "
              f"all_reduce {'ok' if okc else 'FAIL'}; ms (CUDA events, 5 reps): "
              f"{ {k_: round(v_, 4) for k_, v_ in t.items()} }; {smi}")
        check(ok8 and okk and okc, "a collective disagrees with its one-rank meaning")
        report["collectives"] = {"ms": t, "int8_max_err": err8, "int8_limit": limit8,
                                 "topk_kept": kept}
        del g, whole, r8, rk, ek, rc
        gc.collect()
        torch.cuda.empty_cache()

        # make_compressed_dp_step on qwen2-7b at full width, 2 layers, 1 x 2048
        q_cfg = dataclasses.replace(tconfigs.get("qwen2_7b"), n_layers=QWEN_LAYERS, n_groups=0)
        batches = [make_batch_for(q_cfg, 1, QWEN_SEQ, step=i, seed=0, device=dev)
                   for i in range(DP_STEPS)]
        dp = {}
        for method in ("train_step", "exact", "int8", "topk", "chunked"):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model = TrainModel(q_cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
            params = model.params()
            opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
            opt_state = opt.init(params)
            if method == "train_step":
                step_fn = make_train_step(model, opt)
            else:
                step_fn, init_err = make_compressed_dp_step(
                    make_loss_fn(model), opt, mesh, method=method, k_ratio=0.01,
                    chunk_bytes=DP_CHUNK_BYTES)
                err_state = init_err(params)
            reset_counts()
            losses, walls = [], []
            for batch in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if method == "train_step":
                    params, opt_state, met = step_fn(params, opt_state, batch)
                else:
                    params, opt_state, err_state, met = step_fn(params, opt_state, err_state, batch)
                losses.append(met["loss"].item())
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            c_ = counts()
            add(c_)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            wire = wire_bytes(params, {"exact": "fp32", "chunked": "fp32", "train_step": "fp32"}
                              .get(method, method), 0.01)
            dp[method] = {"loss": losses, "step_ms": walls, "peak_gb": peak, "wire_bytes": wire,
                          "flash_launches": c_["flash_attention"]}
            print(f"[17] qwen2-7b {QWEN_LAYERS} layers, batch 1 x {QWEN_SEQ}, "
                  f"{'make_train_step' if method == 'train_step' else 'make_compressed_dp_step ' + method}: "
                  f"loss per step {[round(x_, 6) for x_ in losses]}, step ms {[round(w_, 1) for w_ in walls]}, "
                  f"peak {peak:.2f} GB, wire bytes per all-reduce {wire / 1e9:.3f} GB; launches {c_}; {smi}")
            check(all(math.isfinite(x_) for x_ in losses), f"{method}: a loss is not finite")
            check(c_["flash_attention"] == QWEN_LAYERS * DP_STEPS,
                  f"{method}: {c_['flash_attention']} flash launches, expected {QWEN_LAYERS * DP_STEPS}")
            check(peak < 80.0, f"{method}: peak memory {peak:.2f} GB")
            del model, params, opt, opt_state, step_fn
            if method != "train_step":
                del err_state
        same = all(abs(x_ - y_) <= 1e-5 * max(1.0, abs(y_))
                   for x_, y_ in zip(dp["exact"]["loss"], dp["train_step"]["loss"]))
        print(f"[17] exact against make_train_step, {DP_STEPS} steps: losses "
              f"{dp['exact']['loss']} / {dp['train_step']['loss']} within 1e-5 {'ok' if same else 'FAIL'}; {smi}")
        check(same, "make_compressed_dp_step exact does not give make_train_step's losses")
        report["compressed_dp"] = dp

        # gpipe_apply with the one stage one card has, against its oracle
        x = torch.randn((4, 512, MM_SHAPE[1]), generator=gen, device=dev)
        w = (torch.randn((1, MM_SHAPE[1], MM_SHAPE[1]), generator=gen, device=dev)
             / math.sqrt(MM_SHAPE[1])).requires_grad_(True)
        stage_fn = lambda wp, xmb: torch.tanh(xmb @ wp)  # noqa: E731
        y = gpipe_apply(mesh, "data", stage_fn, w, x)
        (y ** 2).sum().backward()
        gw = w.grad.clone()
        w.grad = None
        y_ref = torch.tanh(x @ w[0])
        (y_ref ** 2).sum().backward()
        ey = (y - y_ref).abs().max().item()
        eg = ((gw - w.grad).abs().max() / w.grad.abs().max()).item()
        okp = ey <= 1e-5 and eg <= 1e-4
        print(f"[17] gpipe_apply, 1 stage, 4 microbatches of (512, {MM_SHAPE[1]}) fp32: max|y - oracle| "
              f"{ey:.3e} (limit 1e-5), gradient max rel {eg:.3e} (limit 1e-4) {'ok' if okp else 'FAIL'}; {smi}")
        check(okp, "gpipe_apply disagrees with its sequential oracle")
        report["gpipe"] = {"y_err": ey, "grad_rel_err": eg}
    finally:
        dist.destroy_process_group()

    # 19. the launch dry run.  The calibration: phase 17's make_train_step
    # cell (remat none) and the same cell under remat="full", measured here,
    # against the dry run's model of each (H100_SXM data sheet, modelled)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = TrainModel(q_cfg, ExecConfig(attn_impl="cuda", remat="full"), device=dev, seed=0)
    params = model.params()
    opt = AdamW(lr=cosine_schedule(1e-3, 10, 50))
    opt_state = opt.init(params)
    real_args = sum(t.numel() * t.element_size() for t in tree_leaves((params, opt_state, batches[0])))
    step_fn = make_train_step(model, opt)
    reset_counts()
    losses, walls = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = step_fn(params, opt_state, batch)
        losses.append(met["loss"].item())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    c_ = counts()
    add(c_)
    peak_full = torch.cuda.max_memory_allocated(dev)
    del model, params, opt, opt_state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    same = all(abs(x_ - y_) <= 1e-5 * max(1.0, abs(y_))
               for x_, y_ in zip(losses, dp["train_step"]["loss"]))
    print(f"[19] qwen2-7b {QWEN_LAYERS} layers, batch 1 x {QWEN_SEQ}, make_train_step under "
          f"remat=\"full\": loss per step {[round(x_, 6) for x_ in losses]} (remat none, phase 17: "
          f"{[round(x_, 6) for x_ in dp['train_step']['loss']]}, within 1e-5 {'ok' if same else 'FAIL'}), "
          f"step ms {[round(w_, 1) for w_ in walls]}, peak {peak_full / 1e9:.2f} GB; launches {c_} "
          f"(each step: {QWEN_LAYERS} forward flash launches and {QWEN_LAYERS} in the recompute); {smi}")
    check(same, "remat=full does not give remat none's losses")
    check(c_["flash_attention"] == 2 * QWEN_LAYERS * DP_STEPS,
          f"remat=full: {c_['flash_attention']} flash launches, expected {2 * QWEN_LAYERS * DP_STEPS}")
    check(peak_full < 80e9, f"remat=full: peak memory {peak_full / 1e9:.2f} GB")
    measured = {"none": (statistics.median(dp["train_step"]["step_ms"][1:]),
                         dp["train_step"]["peak_gb"] * 1e9),
                "full": (statistics.median(walls[1:]), peak_full)}
    report.update(dryrun_phase(out, smi, procs, dry_deadline, q_cfg, measured, real_args))
    (out / "parallel_report.json").write_text(json.dumps(report, indent=1, default=str))
    return launched


def distributed_train(argv) -> int:
    """One rank of ``torchrun``: the training launcher's ``--distributed``
    path (``repro_torch.launch.train.train``); prints its summary, then the
    rank's kernel launches and each step's loss on the last line."""
    import torch  # noqa: F401

    from repro_torch.launch import train
    from repro_torch.runtime import TrainJob

    losses = []
    run = TrainJob.run

    def recording_run(job, *a, **kw):  # the per-step losses, which the summary does not print
        hist = run(job, *a, **kw)
        losses.extend(hist["loss"])
        return hist

    TrainJob.run = recording_run
    reset_counts()
    train.train(argv)
    print(DIST_RESULT + json.dumps({"launches": counts(), "loss": losses}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke"),
                    help="directory for the tuning DBs this run writes")
    ap.add_argument("--train-phases", action="store_true",
                    help="run phases 10-11 and 22-24 only (the child process the full run starts)")
    ap.add_argument("--family-phases", action="store_true",
                    help="run phases 12-15 and 20-21 only (the child process the full run starts)")
    ap.add_argument("--parallel-phases", action="store_true",
                    help="run phases 16-17 and 19 only (the child process the full run starts)")
    ap.add_argument("--distributed-train", nargs=argparse.REMAINDER, default=None,
                    metavar="LAUNCHER_ARGS",
                    help="one torchrun rank of phase 18: repro_torch.launch.train with these "
                         "arguments, then the rank's launch counts")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's kernels run only on the card", file=sys.stderr)
        return 1
    if args.train_phases:
        launched = train_phases(Path(args.out), nvidia_smi())
        print(TRAIN_RESULT + json.dumps(launched))
        return 0
    if args.family_phases:
        launched = family_phases(Path(args.out), nvidia_smi())
        print(FAMILY_RESULT + json.dumps(launched))
        return 0
    if args.parallel_phases:
        launched = parallel_phases(Path(args.out), nvidia_smi())
        print(PARALLEL_RESULT + json.dumps(launched))
        return 0
    if args.distributed_train is not None:
        return distributed_train(args.distributed_train)

    import dataclasses
    import gc

    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core.costs import H100_SXM, roofline_terms
    from repro_torch.kernels import _cuda, autotuned, kernel_router, ops, ref, routed, tune_call
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.autotuned import exec_cache, get_spec, roofline
    from repro_torch.launch import serve
    from repro_torch.models import ExecConfig
    from repro_torch.tuning import TuningDB
    from repro_torch.tuning import pretune

    # plain versions compute in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("tune.json", "tune_csa_nm.json", "pretune.json", "pretune.json.journal",
                 "pretune_analytic.json", "pretune_analytic.json.journal", "route.json",
                 "train.json", "train_report.json", "tune_encoder.json", "family_report.json",
                 *(f"serve_{arch}.json" for arch, _, _ in SERVE),
                 *(f"serve_{arch}.json" for arch in (SEAMLESS, MOONSHOT, QWEN, LLAMA_V, STARCODER)),
                 *(f"serve_{arch}_tiny.json" for arch in FAMILY_TINY),
                 "parallel_report.json", "pretune_launch.json", "pretune_launch.json.journal"):
        (out / name).unlink(missing_ok=True)

    # ---------------------------------------------------------- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[1] device: {kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"[1] build: {', '.join(f'{n} {s:.1f}s' for n, s in built.items()) or 'cached'} "
          f"(wall {time.perf_counter() - t0:.1f}s) into {_cuda.BUILD_DIR}")
    for n in _cuda.SOURCES:
        report = _cuda.ptxas_report(n).splitlines()
        warned = [re.search(r"\((C\d+)\)", ln) for ln in report]
        lines = {ln.split(":", 1)[-1].strip() for ln, w in zip(report, warned)
                 if w is None and ("registers" in ln or "spill" in ln)}
        codes = sorted({w.group(1) for w in warned if w is not None})
        warnings_ = ", ".join(f"{c} x{sum(1 for w in warned if w is not None and w.group(1) == c)}"
                              for c in codes)
        print(f"[1] ptxas {n} (every instantiation): {'; '.join(sorted(lines))}"
              f"{'; performance warnings ' + warnings_ if codes else ''}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    M, K, N = MM_SHAPE
    a = randn((M, K), torch.bfloat16)
    b = randn((K, N), torch.bfloat16, 1.0 / math.sqrt(K))  # weights ~ N(0, 1/d_model)
    B, S, H, Kh, hd = FA_SHAPE
    q = randn((B, S, H, hd), torch.bfloat16)
    k = randn((B, Kh, S, hd), torch.bfloat16)
    v = randn((B, Kh, S, hd), torch.bfloat16)
    dB, dH, dKh, dS, dhd = DA_SHAPE
    dq = randn((dB, dH, dhd), torch.bfloat16)
    dk = randn((dB, dKh, dS, dhd), torch.bfloat16)
    dv = randn((dB, dKh, dS, dhd), torch.bfloat16)
    lens = torch.randint(1, dS + 1, (dB,), generator=gen, device=dev)  # a valid prefix per row
    dvalid = (torch.arange(dS, device=dev)[None] < lens[:, None]).to(torch.int32)
    # the scans at the serving prefill's shapes: RG-LRU decays in (0, 1)
    lru_a = torch.sigmoid(randn(LRU_SHAPE, torch.float32))
    lru_b = randn(LRU_SHAPE, torch.float32)
    lru_h0 = randn(LRU_SHAPE[::2], torch.float32)
    rB, rT, rH, rhd = RWKV_SHAPE
    rr, rk, rv = (randn(RWKV_SHAPE, torch.bfloat16) for _ in range(3))
    rlw = -torch.exp(randn(RWKV_SHAPE, torch.float32))  # log decay <= 0
    ru = randn((rH, rhd), torch.float32, 0.5)
    rs0 = randn((rB, rH, rhd, rhd), torch.float32)
    call_args = {"matmul": ((a, b), {}), "flash_attention": ((q, k, v), {"causal": True}),
                 "decode_attention": ((dq, dk, dv, dvalid), {}),
                 "lru_scan": ((lru_a, lru_b, lru_h0), {}),
                 "rwkv_scan": ((rr, rk, rv, rlw, ru, rs0), {})}
    defaults = {name: get_spec(name).defaults(*ca, **kw) for name, (ca, kw) in call_args.items()}
    names = list(call_args)

    # -------------------------------------------- 2. kernels vs plain versions
    max_err = {name: 0.0 for name in KERNELS}

    def compare(label, name, got, want, phase=2, full=None):
        """Hold got against want; ``full`` (default: more than a million
        elements) marks a main-path shape, whose error the JSON line reports."""
        ok, err, mag, worst = True, 0.0, 0.0, 0.0
        torch.cuda.synchronize()
        for g_, w_ in zip(_tensors(got), _tensors(want)):
            tol = TOL[name][str(g_.dtype).replace("torch.", "")]
            e = (g_.float() - w_.float()).abs().max().item()
            ok = ok and g_.shape == w_.shape and math.isfinite(e) and bool(
                torch.allclose(g_.float(), w_.float(), atol=tol, rtol=tol))
            err, mag = max(err, e), max(mag, w_.float().abs().max().item())
            if g_.shape == w_.shape:  # the largest |error| over its allclose limit
                worst = max(worst, ((g_.float() - w_.float()).abs()
                                    / (tol + tol * w_.float().abs())).max().item())
            if g_.shape == w_.shape and (g_.numel() > 1_000_000 if full is None else full):
                max_err[name] = max(max_err[name], e)
        tol = TOL[name][str(_tensors(got)[0].dtype).replace("torch.", "")]
        print(f"[{phase}] {label}: max_abs_err={err:.3e} max|plain|={mag:.4g} "
              f"worst err/limit={worst:.3f} allclose(atol={tol:g}, rtol={tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: kernel disagrees with its plain version")

    def compare_bwd(label, name, got, want, outputs):
        """Hold each backward output against its plain version by
        ||got - want|| / ||want|| at ``BWD_REL``; the JSON line reports the
        largest |error|."""
        ok, parts = True, []
        torch.cuda.synchronize()
        for out_, g_, w_ in zip(outputs, got, want):
            rel_ = bwd_rel(g_, w_)
            limit_ = BWD_REL[str(g_.dtype).replace("torch.", "")]
            ok = ok and g_.shape == w_.shape and g_.dtype == w_.dtype and rel_ <= limit_
            max_err[name] = max(max_err[name], (g_.float() - w_.float()).abs().max().item())
            parts.append(f"{out_} {rel_:.2e} ({str(g_.dtype).replace('torch.', '')}, limit {limit_:g})")
        print(f"[2] {label}: ||kernel - plain|| / ||plain|| per output: {', '.join(parts)}; "
              f"max_abs_err={max_err[name]:.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: kernel disagrees with its plain version")

    def ran(module, call):
        """Run ``call`` once; the design whose launch count it raised."""
        before = dict(module.launches_by_design)
        got = call()
        torch.cuda.synchronize()
        grew = [d for d, n in module.launches_by_design.items() if n > before[d]]
        return got, grew[0] if len(grew) == 1 else f"unclear {grew}"

    for knobs, want in ((defaults["matmul"], "wgmma"), ({"bm": 64, "bn": 128, "bk": 64}, "wgmma"),
                        ({"bm": 32, "bn": 128, "bk": 32}, "simt")):
        got, design = ran(mm, lambda: ops.matmul(a, b, **knobs))
        compare(f"matmul bf16 {M}x{K}x{N} {knobs} ({design})", "matmul", got,
                mm.matmul_plain(a, b, **knobs))
        check(design == want, f"matmul {knobs} ran the {design} design, expected {want}")
    a32 = randn((256, 192), torch.float32)
    b32 = randn((192, 128), torch.float32, 1.0 / math.sqrt(192))
    knobs = {"bm": 64, "bn": 32, "bk": 32}
    compare(f"matmul fp32 256x192x128 {knobs}", "matmul", ops.matmul(a32, b32, **knobs),
            mm.matmul_plain(a32, b32, **knobs))

    for knobs, want_design in ((defaults["flash_attention"], "wgmma"), ({"block_q": 64, "block_kv": 64}, "wgmma"),
                               ({"block_q": 32, "block_kv": 64}, "simt")):
        got, design = ran(fa, lambda: ops.flash_attention(q, k, v, causal=True, **knobs))
        want = fa.flash_attention_plain(q.transpose(1, 2), k, v, causal=True, **knobs).transpose(1, 2)
        compare(f"flash_attention bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal {knobs} ({design})",
                "flash_attention", got, want)
        check(design == want_design, f"flash_attention {knobs} ran the {design} design, expected {want_design}")
    for causal in (True, False):
        q32 = randn((1, 64, 8, 32), torch.float32)
        k32 = randn((1, 2, 64, 32), torch.float32)
        v32 = randn((1, 2, 64, 32), torch.float32)
        knobs = {"block_q": 16, "block_kv": 32}
        got = ops.flash_attention(q32, k32, v32, causal=causal, **knobs)
        want = fa.flash_attention_plain(q32.transpose(1, 2), k32, v32, causal=causal,
                                        **knobs).transpose(1, 2)
        compare(f"flash_attention fp32 q(1, 64, 8, 32) kv(1, 2, 64, 32) causal={causal} {knobs}",
                "flash_attention", got, want)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def split_of(args, knobs):
        """(splits, grid) the decode kernel runs ``args`` with at ``knobs``."""
        q_, k_ = args[0], args[1]
        g_ = q_.shape[1] // k_.shape[1]
        tile = da.legal_tile(g_, q_.shape[2], k_.shape[2], knobs["block_kv"], on_card=True)
        grid_ = da.grid(q_.shape[0], k_.shape[1], g_, k_.shape[2], tile, n_sm)
        return grid_[2], grid_

    da_args = call_args["decode_attention"][0]
    for knobs in (defaults["decode_attention"], {"block_kv": 128}):
        nsplit, grid_ = split_of(da_args, knobs)
        got, design = ran(da, lambda: ops.decode_attention(*da_args, **knobs))
        compare(f"decode_attention bf16 q{tuple(dq.shape)} kv{tuple(dk.shape)} valid prefixes "
                f"{lens.tolist()} {knobs} ({nsplit} splits, grid {grid_} = "
                f"{math.prod(grid_)} blocks on {n_sm} SMs, {design} loads)", "decode_attention", got,
                da.decode_attention_plain(*da_args, **knobs, splits=nsplit), full=True)
        check(design == "vec16", f"decode_attention {knobs} at the main shape ran {design} loads")
    # recurrentgemma-2b's served MQA decode: the ring buffer's slot s holds
    # the latest position p <= t with p = s (mod W); the model's mask keeps
    # p <= t and t - p < W (models/attention.py::_mask)
    gB, gH, gKh, gW, ghd = RG_DA_SHAPE
    t_pos = RING_TOKENS - 1
    slots = torch.arange(gW, device=dev)
    ring_pos = slots + ((t_pos - slots) // gW) * gW
    ring_valid = ((ring_pos >= 0) & (ring_pos <= t_pos) & (t_pos - ring_pos < gW)).to(torch.int32)
    rg_args = (randn((gB, gH, ghd), torch.bfloat16), randn((gB, gKh, gW, ghd), torch.bfloat16),
               randn((gB, gKh, gW, ghd), torch.bfloat16), ring_valid[None].expand(gB, gW).contiguous())
    for knobs in (get_spec("decode_attention").defaults(*rg_args), {"block_kv": 64}):
        nsplit, grid_ = split_of(rg_args, knobs)
        compare(f"decode_attention bf16 recurrentgemma-2b MQA q{tuple(rg_args[0].shape)} "
                f"kv{tuple(rg_args[1].shape)} ring after {RING_TOKENS} tokens "
                f"({int(ring_valid.sum())} of {gW} slots valid) {knobs} ({nsplit} splits, grid "
                f"{grid_})", "decode_attention", ops.decode_attention(*rg_args, **knobs),
                da.decode_attention_plain(*rg_args, **knobs, splits=nsplit), full=True)
    # fp32, and rows with no valid slot (mean of V) or a masked leading part
    small_da = [randn((2, 14, 64), torch.float32), randn((2, 2, 256, 64), torch.float32),
                randn((2, 2, 256, 64), torch.float32), torch.ones(2, 256, dtype=torch.int32, device=dev)]
    small_da[3][0] = 0
    small_da[3][1, :100] = 0
    got = ops.decode_attention(*small_da, block_kv=64)
    small_splits = split_of(small_da, {"block_kv": 64})[0]
    mean_v = small_da[2][0].mean(dim=1).repeat_interleave(7, dim=0)
    invalid_ok = bool(torch.isfinite(got).all()) and bool(
        torch.allclose(got[0], mean_v, atol=1e-5, rtol=1e-5))
    print(f"[2] decode_attention fp32 row with no valid slot: mean of V "
          f"max |o - mean(v)| {(got[0] - mean_v).abs().max().item():.3e} {'ok' if invalid_ok else 'FAIL'}")
    check(invalid_ok, "decode_attention: a row with no valid slot is not the mean of V")
    compare("decode_attention fp32 q(2, 14, 64) kv(2, 2, 256, 64) block_kv=64, rows all / first "
            "100 slots invalid", "decode_attention", got,
            da.decode_attention_plain(*small_da, block_kv=64, splits=small_splits), full=False)

    def lru_segments(args, knobs):
        """Segments the lru kernel runs ``args`` with at ``knobs``."""
        a_ = args[0]
        L, bd = ls.legal_lru(a_.shape[1], a_.shape[2], knobs["chunk"], knobs.get("block_d", ls.LRU_BLOCK_D),
                             on_card=True, itemsize=a_.element_size())
        return ls.lru_segments(*a_.shape, L, bd, a_.element_size(), n_sm)

    def lru_compare(label, args, knobs, got=None, phase=2):
        """The lru kernel against the exact scan and against its segmented
        arithmetic at the segment count it ran."""
        nseg = lru_segments(args, knobs)
        got = ops.lru_scan(*args, **knobs) if got is None else got
        compare(f"{label} (segmented, {nseg} segments) vs the exact scan", "lru_scan", got,
                ls.lru_scan_plain(*args, **knobs), phase=phase)
        compare(f"{label} (segmented, {nseg} segments) vs lru_scan_segmented_plain", "lru_scan", got,
                ls.lru_scan_segmented_plain(*args, segments=nseg), phase=phase)

    lru_args = call_args["lru_scan"][0]
    for knobs in (defaults["lru_scan"], {"chunk": 4}, {"chunk": 32, "block_d": 64}):
        lru_compare(f"lru_scan fp32 a,b{LRU_SHAPE} {knobs}", lru_args, knobs)
    rwkv_args = call_args["rwkv_scan"][0]
    for knobs in (defaults["rwkv_scan"], {"chunk": 4}, {"chunk": 16}):
        got, design = ran(ls, lambda: ops.rwkv_scan(*rwkv_args, **knobs))
        compare(f"rwkv_scan bf16 r,k,v{RWKV_SHAPE} lw,u,s0 fp32 {knobs} ({design})", "rwkv_scan",
                got, ls.rwkv_scan_plain(*rwkv_args, **knobs))
        check(design == "tc", f"rwkv_scan {knobs} at the serving shape ran {design}, not tc")
    got = ls._rwkv_launch(*rwkv_args, 4, "per_token")
    compare(f"rwkv_scan bf16 r,k,v{RWKV_SHAPE} chunk=4 through the per_token entry point", "rwkv_scan",
            got, ls.rwkv_scan_plain(*rwkv_args, chunk=4))
    small_lru = (torch.sigmoid(randn((2, 64, 96), torch.float32)), randn((2, 64, 96), torch.float32),
                 randn((2, 96), torch.float32))
    lru_compare("lru_scan fp32 a,b(2, 64, 96) {'chunk': 16, 'block_d': 32}", small_lru,
                {"chunk": 16, "block_d": 32})
    for hd_, strong in ((8, False), (32, False), (64, True)):
        shape = (2, 64, 2, hd_)
        small = [randn(shape, torch.float32) for _ in range(3)]
        small.append(torch.full(shape, -14.0, device=dev) if strong
                     else -torch.exp(randn(shape, torch.float32)))
        small += [randn((2, hd_), torch.float32, 0.5), randn((2, 2, hd_, hd_), torch.float32)]
        got, design = ran(ls, lambda: ops.rwkv_scan(*small, chunk=16))
        check(bool(torch.isfinite(got[0]).all()), f"rwkv_scan hd {hd_}: non-finite output")
        compare(f"rwkv_scan fp32 r,k,v{shape}{' lw=-14' if strong else ''} chunk=16 ({design})",
                "rwkv_scan", got, ls.rwkv_scan_plain(*small, chunk=16))
        check(design == "per_token", f"rwkv_scan fp32 ran {design}, not per_token")
    # bf16 at strong decay through the tensor-core design
    shape = (2, 64, 2, 64)
    strong = [randn(shape, torch.bfloat16) for _ in range(3)]
    strong += [torch.full(shape, -14.0, device=dev), randn((2, 64), torch.float32, 0.5),
               randn((2, 2, 64, 64), torch.float32)]
    got, design = ran(ls, lambda: ops.rwkv_scan(*strong, chunk=16))
    check(bool(torch.isfinite(got[0].float()).all()) and design == "tc",
          f"rwkv_scan bf16 lw=-14: design {design}, finite {bool(torch.isfinite(got[0].float()).all())}")
    compare(f"rwkv_scan bf16 r,k,v{shape} lw=-14 chunk=16 ({design})", "rwkv_scan", got,
            ls.rwkv_scan_plain(*strong, chunk=16))

    # the scans' backward kernels at the trained shapes, against their plain
    # versions, with the final-state cotangents nonzero; then one call of
    # each under torch.profiler at two sequence lengths: the same kernels
    lb_knobs = {"chunk": TRAIN_REC_CHUNK, "block_d": ls.LRU_BLOCK_D}

    def lru_bwd_args(shape):
        a_ = torch.sigmoid(randn(shape, torch.float32))
        return (a_, randn(shape, torch.float32), randn(shape[::2], torch.float32),
                randn(shape, torch.float32), randn(shape[::2], torch.float32))

    def rwkv_bwd_args(shape):
        B_, _, H_, hd_ = shape
        return (*(randn(shape, torch.bfloat16) for _ in range(3)),
                -torch.exp(randn(shape, torch.float32)), randn((H_, hd_), torch.float32, 0.5),
                randn((B_, H_, hd_, hd_), torch.float32), randn(shape, torch.bfloat16),
                randn((B_, H_, hd_, hd_), torch.float32))

    lb_args = lru_bwd_args(LRU_BWD_SHAPE)
    rb_args = rwkv_bwd_args(RWKV_BWD_SHAPE)
    bwd_calls = {"lru_scan_bwd": lambda args_: ls.lru_scan_bwd(*args_, **lb_knobs),
                 "rwkv_scan_bwd": lambda args_: ls.rwkv_scan_bwd(*args_)}
    lb_tiling = ls.lru_bwd_tiling(*LRU_BWD_SHAPE[1:], 4)
    lb_design = (f"one fused kernel, {LRU_BWD_SHAPE[0] * LRU_BWD_SHAPE[2] // lb_tiling.cw} blocks of "
                 f"{lb_tiling.cw} channels over T, {lb_tiling.nsub} sub-segments of "
                 f"{-(-lb_tiling.tile // lb_tiling.nsub)} rows, {lb_tiling.tiles} tile(s) of {lb_tiling.tile} rows")
    lb_got = bwd_calls["lru_scan_bwd"](lb_args)
    lb_want = ls.lru_scan_bwd_plain(*lb_args, **lb_knobs)
    compare_bwd(f"lru_scan_bwd fp32 a,b,g{LRU_BWD_SHAPE} g_T nonzero {lb_knobs} ({lb_design})",
                "lru_scan_bwd", lb_got, lb_want, ("da", "db", "dh0"))
    lb_seg = ls.lru_scan_bwd_segmented_plain(*lb_args, subsegments=lb_tiling.nsub,
                                             tile=lb_tiling.tile if lb_tiling.tiles > 1 else 0)
    lb_seg_rel = [bwd_rel(g_, s_) for g_, s_ in zip(lb_got, lb_seg)]
    print(f"[2] lru_scan_bwd against lru_scan_bwd_segmented_plain at its tiling: ||kernel - plain|| / "
          f"||plain|| da, db, dh0 {', '.join(f'{r_:.2e}' for r_ in lb_seg_rel)} "
          f"(limit {LRU_BWD_SEG_REL:g})")
    check(max(lb_seg_rel) <= LRU_BWD_SEG_REL,
          f"lru_scan_bwd disagrees with its segmented plain version: {lb_seg_rel}")
    lb_same = all(torch.equal(g_, a_) for g_, a_ in zip(lb_got, bwd_calls["lru_scan_bwd"](lb_args)))
    print(f"[2] lru_scan_bwd: two calls on the same inputs bit-identical: {lb_same}")
    check(lb_same, "lru_scan_bwd: two calls differ")
    # a planted fault the limit must reject: da formed with h_t in place of
    # h_{t-1} (db times the exact forward's hs)
    lb_fault = lb_want[1] * ref.lru_scan_ref(*lb_args[:3])[0]
    rel_ = bwd_rel(lb_fault, lb_want[0])
    print(f"[2] planted fault: lru_scan_bwd's da formed with h_t in place of h_(t-1) against the plain "
          f"version: ||fault - plain|| / ||plain|| {rel_:.2e} (limit {BWD_REL['float32']:g}) "
          f"{'rejected' if rel_ > BWD_REL['float32'] else 'ACCEPTED'}")
    check(rel_ > BWD_REL["float32"], "the backward limit accepts the lru da formed with h_t")
    del lb_got, lb_want, lb_seg, lb_fault
    rb_slices = ls.rwkv_bwd_slices(RWKV_BWD_SHAPE[0], RWKV_BWD_SHAPE[2], RWKV_BWD_SHAPE[3], n_sm)
    rb_chunk = ls.rwkv_bwd_chunk(RWKV_BWD_SHAPE[1], RWKV_BWD_SHAPE[3], rb_slices)
    rb_seg = ls.rwkv_bwd_segment(RWKV_BWD_SHAPE[1], rb_chunk)
    rb_outputs = ("dr", "dk", "dv", "dlw", "du", "ds0")
    rb_want = ls.rwkv_scan_bwd_plain(*rb_args)
    compare_bwd(f"rwkv_scan_bwd bf16 r,k,v,gy{RWKV_BWD_SHAPE} lw,u,s0 fp32 gs_T nonzero (chunk {rb_chunk}, "
                f"checkpoints every {rb_seg} tokens, {rb_slices} row slices a (head, batch row) in a "
                f"cluster: {RWKV_BWD_SHAPE[0] * RWKV_BWD_SHAPE[2] * rb_slices} blocks)", "rwkv_scan_bwd",
                rb_got := bwd_calls["rwkv_scan_bwd"](rb_args), rb_want, rb_outputs)
    rb_same = all(torch.equal(g_, a_) for g_, a_ in zip(rb_got, bwd_calls["rwkv_scan_bwd"](rb_args)))
    print(f"[2] rwkv_scan_bwd: two calls on the same inputs bit-identical: {rb_same}")
    check(rb_same, "rwkv_scan_bwd: two calls differ")
    del rb_got
    # a planted fault the limit must reject: dk or dv without its u term
    # (u (r_t . gy_t)-weighted terms, computed by the plain version at u = 0)
    rb_no_u = ls.rwkv_scan_bwd_plain(*rb_args[:4], torch.zeros_like(rb_args[4]), *rb_args[5:])
    for i_ in (1, 2):
        rel_ = bwd_rel(rb_no_u[i_], rb_want[i_])
        w_ = rb_want[i_].float()
        print(f"[2] planted fault: rwkv_scan_bwd's {rb_outputs[i_]} without its u term against the plain "
              f"version: ||fault - plain|| / ||plain|| {rel_:.2e} (limit {BWD_REL['bfloat16']:g}) "
              f"{'rejected' if rel_ > BWD_REL['bfloat16'] else 'ACCEPTED'}; max |fault - plain| / max |plain| "
              f"{((rb_no_u[i_].float() - w_).abs().max() / w_.abs().max()).item():.2e}")
        check(rel_ > BWD_REL["bfloat16"], f"the backward limit accepts {rb_outputs[i_]} without its u term")
    del rb_want, rb_no_u
    bwd_kernel_counts = {}
    for name, shape, args_ in (("lru_scan_bwd", LRU_BWD_SHAPE, lb_args),
                               ("rwkv_scan_bwd", RWKV_BWD_SHAPE, rb_args)):
        other = list(shape)
        other[1] = BWD_SHAPES_T[name]
        seen = {}
        for shape_, a_ in ((shape, args_), (tuple(other), None)):
            if a_ is None:
                a_ = (lru_bwd_args if name == "lru_scan_bwd" else rwkv_bwd_args)(shape_)
            bwd_calls[name](a_)  # warm
            busy_, kernels_ = trace_busy(out, lambda: bwd_calls[name](a_), 1, f"{name}_T{shape_[1]}")
            seen[shape_[1]] = {"kernels": kernels_, "device_busy_ms": busy_}
            del a_
        bwd_kernel_counts[name] = seen
        print(f"[2] {name} under torch.profiler, one call: device kernels (copies and memsets "
              f"included) and busy ms by T: {seen}")
        check(len({v_["kernels"] for v_ in seen.values()}) == 1,
              f"{name}: the kernel count of one backward call depends on T: {seen}")
        check(name != "lru_scan_bwd" or all(v_["kernels"] == 1 for v_ in seen.values()),
              f"lru_scan_bwd: one call ran more than one device kernel: {seen}")

    # flash attention's backward kernel at the trained shapes, q, k, v and dO
    # as strided views (as ops.flash_attention and attn_apply pass them), o
    # and lse from the forward kernel: against its plain version, two calls
    # bit-identical; a planted fault (dS without its -D term: the plain
    # version on o = 0) the same limit must reject; one call under
    # torch.profiler at two sequence lengths: the same kernel count
    def fa_bwd_args(shape, dtype, causal):
        B_, S_, H_, Kh_, hd_ = shape
        dt_ = getattr(torch, dtype)
        q_ = randn((B_, S_, H_, hd_), dt_).transpose(1, 2)
        k_, v_ = (randn((B_, S_, Kh_, hd_), dt_).transpose(1, 2) for _ in range(2))
        do_ = randn((B_, S_, H_, hd_), dt_).transpose(1, 2)
        o_, lse_ = fa.flash_attention_fwd(q_, k_, v_, causal=causal, return_lse=True, block_q=64, block_kv=64)
        return q_, k_, v_, o_, lse_, do_

    def fa_splits(q_, k_):
        return fa.bwd_head_splits(k_.shape[0], k_.shape[1], q_.shape[1] // k_.shape[1], k_.shape[2], n_sm)

    fb_args = {}
    for label, shape, dtype, causal in FA_BWD_CASES:
        args_ = fa_bwd_args(shape, dtype, causal)
        q_, k_, v_, o_, lse_, do_ = args_
        _, lse_plain = fa.flash_attention_plain(q_, k_, v_, causal=causal, return_lse=True, block_q=64,
                                                block_kv=64)
        lse_err = (lse_ - lse_plain).abs().max().item()
        print(f"[2] flash_attention forward's lse at the {label} shape against its plain version: "
              f"max|kernel - plain| {lse_err:.3e}")
        check(lse_err <= 1e-4, f"flash_attention lse at the {label} shape: {lse_err:.3e}")
        del lse_plain
        got, design = ran(fa, lambda: fa.flash_attention_bwd(*args_, causal=causal))
        want = fa.flash_attention_bwd_plain(*args_, causal=causal)
        check(design == ("bwd_wgmma" if dtype == "bfloat16" else "bwd_simt"),
              f"flash_attention_bwd {dtype} at the {label} shape ran {design}")
        splits_ = fa_splits(q_, k_) if design == "bwd_wgmma" else 1
        compare_bwd(f"flash_attention_bwd {dtype} {label} q{tuple(q_.shape)} kv{tuple(k_.shape)} causal={causal} "
                    f"({design}, {splits_} head splits: {fa.bwd_scratch_bytes(k_.shape[0], k_.shape[1], k_.shape[2], k_.shape[3], splits_) / 1e6:.1f} MB "
                    f"of fp32 dK/dV partials; q, k, v, dO strided)", "flash_attention_bwd", got, want,
                    ("dq", "dk", "dv"))
        again = fa.flash_attention_bwd(*args_, causal=causal)
        same = all(torch.equal(g_, a_) for g_, a_ in zip(got, again))
        print(f"[2] flash_attention_bwd {label}: two calls on the same inputs bit-identical: {same}")
        check(same, f"flash_attention_bwd at the {label} shape: two calls differ")
        if label == "qwen2-7b layer":
            no_d = fa.flash_attention_bwd_plain(q_, k_, v_, torch.zeros_like(o_), lse_, do_, causal=causal)
            for i_, name_ in ((0, "dq"), (1, "dk")):
                rel_ = bwd_rel(no_d[i_], want[i_])
                print(f"[2] planted fault: flash_attention_bwd's {name_} without its -D term against the plain "
                      f"version: ||fault - plain|| / ||plain|| {rel_:.2e} (limit {BWD_REL['bfloat16']:g}) "
                      f"{'rejected' if rel_ > BWD_REL['bfloat16'] else 'ACCEPTED'}")
                check(rel_ > BWD_REL["bfloat16"], f"the backward limit accepts {name_} without its -D term")
            del no_d
        fb_args[label] = args_
        del got, want, again
    bwd_calls["flash_attention_bwd"] = lambda args_: fa.flash_attention_bwd(*args_, causal=True)
    qwen_bwd = next(c_ for c_ in FA_BWD_CASES if c_[0] == "qwen2-7b layer")
    seen = {}
    for S_ in (qwen_bwd[1][1], BWD_SHAPES_T["flash_attention_bwd"]):
        shape_ = (qwen_bwd[1][0], S_, *qwen_bwd[1][2:])
        a_ = fb_args["qwen2-7b layer"] if S_ == qwen_bwd[1][1] else fa_bwd_args(shape_, "bfloat16", True)
        bwd_calls["flash_attention_bwd"](a_)  # warm
        busy_, kernels_ = trace_busy(out, lambda: bwd_calls["flash_attention_bwd"](a_), 1,
                                     f"flash_attention_bwd_S{S_}")
        seen[S_] = {"kernels": kernels_, "device_busy_ms": busy_}
        del a_
    bwd_kernel_counts["flash_attention_bwd"] = seen
    print(f"[2] flash_attention_bwd under torch.profiler, one call at the qwen2-7b layer's heads: device "
          f"kernels (copies and memsets included) and busy ms by S: {seen}")
    check(len({v_["kernels"] for v_ in seen.values()}) == 1,
          f"flash_attention_bwd: the kernel count of one backward call depends on S: {seen}")

    max_err["adamw"] = adamw_check(dev, gen)
    print(f"[2] adamw: the multi-tensor kernel against adamw_plain on a ragged tree (lengths 1 to 65541, "
          f"one leaf 4 bytes past a 16-byte boundary), fp32 and bf16 state, 3 steps with the clip engaged: "
          f"fp32 state within {max_err['adamw']:.2e} of each leaf's scale (limit 1e-6), bf16 within a bf16 "
          f"step, the global norm to 1e-6, {ADAMW_LAUNCHES} launches an update")
    check(all(n > 0 for n in counts().values()), f"phase 2 did not launch every kernel: {counts()}")
    print(f"[2] launches: {counts()}")

    # ---------------------------------------- main path 1: tuning loop, 3-5
    reset_counts()
    phase_launches = {}

    # 3. the tuning loop
    tune_db = TuningDB(str(out / "tune.json"))
    records = {}
    for name, (ca, kw) in call_args.items():
        stats: dict = {}
        t0 = time.perf_counter()
        rec = tune_call(name, *ca, db=tune_db, measure_stats=stats, **kw)
        dt = time.perf_counter() - t0
        check(rec is not None, f"tune_call({name}) committed no record")
        print(f"[3] tune_call {name}: point={rec.point} cost={rec.cost * 1e3:.4f}ms "
              f"cost_std={(rec.cost_std or 0.0) * 1e3:.4f}ms repeats_spent={rec.repeats_spent} "
              f"evals={rec.evals} crashed={rec.crashed} reps={stats.get('reps')} "
              f"calibration_reps={stats.get('calibration_reps')} culled={stats.get('culled')} "
              f"pruned={stats.get('pruned_roofline')} backend={rec.key.backend} "
              f"device_kind={rec.key.device_kind} ({dt:.1f}s)")
        check(rec.key.backend == "cuda", f"{name}: record backend {rec.key.backend!r} is not 'cuda'")
        check(rec.key.device_kind == kind, f"{name}: record device_kind {rec.key.device_kind!r}")
        check(math.isfinite(rec.cost), f"{name}: committed cost is not finite")
        records[name] = rec
    # the same decode context searched by the paper's CSA -> NM pipeline
    stats = {}
    t0 = time.perf_counter()
    rec = tune_call("decode_attention", *call_args["decode_attention"][0],
                    db=TuningDB(str(out / "tune_csa_nm.json")), strategy="csa+nm", measure_stats=stats)
    check(rec is not None and rec.strategy == "csa+nm" and math.isfinite(rec.cost),
          "tune_call(decode_attention, strategy='csa+nm') committed no finite csa+nm record")
    print(f"[3] tune_call decode_attention strategy=csa+nm: point={rec.point} "
          f"cost={rec.cost * 1e3:.4f}ms evals={rec.evals} crashed={rec.crashed} "
          f"reps={stats.get('reps')} culled={stats.get('culled')} ({time.perf_counter() - t0:.1f}s)")
    records_csa_nm = rec
    phase_launches["tune"] = counts()

    # 4. replay from the DB as written to disk; its output is held against
    # the kernel at the stored knobs after the main path's counts are read
    replay_db = TuningDB(str(out / "tune.json"), autosave=False)
    replayed = {}
    for name, (ca, kw) in call_args.items():
        before = counts()[name]
        got = autotuned(name, *ca, db=replay_db, **kw)
        torch.cuda.synchronize()
        spent = counts()[name] - before
        print(f"[4] autotuned {name}: launches={spent} point={records[name].point} "
              f"shape={[tuple(t.shape) for t in _tensors(got)]}")
        check(spent == 1, f"autotuned({name}) launched {spent} kernels, expected exactly 1")
        replayed[name] = got
    phase_launches["replay"] = {n: c - phase_launches["tune"][n] for n, c in counts().items()}

    # 5. the pretune CLI, twice, in-process
    before = counts()
    for run in (1, 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pretune.main(["--smoke", "--db", str(out / "pretune.json")])
        for line in buf.getvalue().splitlines():
            print(f"[5] run {run}: {line}")
        check(rc == 0, f"pretune run {run} exited {rc}")
        m = re.search(r"(\d+) contexts tuned \((\d+) exact hits, (\d+) searched\)", buf.getvalue())
        check(m is not None, f"pretune run {run}: no summary line")
        if run == 2:
            check(int(m.group(3)) == 0 and int(m.group(2)) == int(m.group(1)) > 0,
                  "pretune run 2 searched again instead of making only exact hits")
    buf = io.StringIO()
    analytic_db, obs_dir = out / "pretune_analytic.json", out / "obs"
    with contextlib.redirect_stdout(buf):
        rc = pretune.main(["--smoke", "--strategy", "csa+nm", "--cost", "analytic",
                           "--db", str(analytic_db), "--obs-dir", str(obs_dir)])
    for line in buf.getvalue().splitlines():
        print(f"[5] csa+nm analytic: {line}")
    check(rc == 0 and "5 contexts tuned" in buf.getvalue(), f"pretune --strategy csa+nm --cost "
          f"analytic exited {rc} or did not tune the 5 smoke contexts")
    check(buf.getvalue().count("strategy=csa+nm") == 5, "pretune --strategy csa+nm: records not csa+nm")
    phase_launches["pretune"] = {n: c - before[n] for n, c in counts().items()}
    tuning_launches = counts()

    # the host-side CLI on this run's files (no card needed)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["db", "list", "--db", str(out / "pretune.json")],
                ["db", "diff", str(out / "pretune.json"), str(out / "pretune.json")],
                ["report", str(obs_dir), "--db", str(analytic_db)]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.tune", *cmd], capture_output=True,
                              text=True, env=env, cwd=str(ROOT), timeout=300)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[5] tune {cmd[0]}{' ' + cmd[1] if cmd[0] == 'db' else ''}: {line}")
        check(proc.returncode == 0, f"python -m repro_torch.tune {' '.join(cmd)} exited {proc.returncode}")
    print(f"[5] tuning-loop launches: {tuning_launches} by phase: {phase_launches}")
    for name in names:
        check(tuning_launches[name] > 0, f"the tuning loop never launched the {name} kernel")

    for name, got in replayed.items():
        ca, kw = call_args[name]
        want = get_spec(name).fn(*ca, **kw, **records[name].point)
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(_tensors(got), _tensors(want)))
        finite = all(bool(torch.isfinite(g_.float()).all()) for g_ in _tensors(got))
        print(f"[4] autotuned {name}: bit_equal={equal} finite={finite} "
              "(against the kernel at the stored knobs)")
        check(equal and finite, f"autotuned({name}) output differs from the kernel at the stored knobs")
    del replayed

    # ------------------------------------------- main path 2: the route, 6
    # every call's knobs are read off its decision; the first output at
    # each knob setting is kept and every later one must equal it (no
    # launch), and after the counts are read each kept output is held
    # against the kernel launched at those knobs
    reset_counts()
    route_db = out / "route.json"
    served: dict = {}
    repeat_equal = [True]

    def stream(router, name, calls):
        decisions = []
        begin = router.begin

        def noting(*b_args, **b_kw):
            d = begin(*b_args, **b_kw)
            decisions.append(dict(d.point))
            return d

        router.begin = noting
        ca, kw = call_args[name]
        t0 = time.perf_counter()
        try:
            for _ in range(calls):
                got = routed(name, *ca, router=router, **kw)
                key = (name, tuple(sorted(decisions[-1].items())))
                if key in served:
                    repeat_equal[0] &= all(torch.equal(g_, w_) for g_, w_ in
                                           zip(_tensors(got), _tensors(served[key])))
                else:
                    served[key] = got
        finally:
            router.begin = begin
        return time.perf_counter() - t0, decisions

    router = kernel_router(db=TuningDB(str(route_db)), epsilon=0.1, fresh=True)
    route_points = {}
    for name, calls in ROUTE_CALLS.items():
        dt, decisions = stream(router, name, calls)
        route_points[name] = decisions
        print(f"[6] routed {name}: {calls} calls in {dt:.2f}s, knobs served "
              f"{sorted({tuple(sorted(p.items())) for p in decisions})}")
    router.wait_pending()
    st = router.stats()
    print(f"[6] router: calls={st['calls']} explores={st['explores']} exploits={st['exploits']} "
          f"deferred_explores={st['deferred_explores']} candidate_failures={st['candidate_failures']} "
          f"searches_completed={st['searches_completed']} drift_resets={st['drift_resets']} "
          f"inband_builds={st['inband_builds']} contexts={st['contexts']}")
    check(st["calls"] == st["explores"] + st["exploits"] == sum(ROUTE_CALLS.values()),
          f"router accounting does not balance: {st}")
    check(st["inband_builds"] == 0, "a router build ran on the serving thread")
    route_recs = {r.key.name: r for r in TuningDB(str(route_db), autosave=False).records()}
    check("decode_attention" in route_recs, "the router committed no decode_attention record")
    drec = route_recs["decode_attention"]
    for n, r in sorted(route_recs.items()):
        print(f"[6] committed {n}: {r.point} cost={r.cost * 1e3:.4f}ms source={r.source} "
              f"evals={r.evals} backend={r.key.backend} device_kind={r.key.device_kind}")
    check(drec.key.backend == "cuda" and drec.key.device_kind == kind,
          f"route record keyed {drec.key.backend}/{drec.key.device_kind}, not this card")
    # a second router on the same DB: an exact hit from its first call
    router2 = kernel_router(db=TuningDB(str(route_db), autosave=False), epsilon=0.1, fresh=True)
    dt, decisions2 = stream(router2, "decode_attention", 20)
    st2 = router2.stats()
    ctx2 = router2.contexts()
    print(f"[6] second router: 20 calls in {dt:.2f}s, explores={st2['explores']} "
          f"exploits={st2['exploits']} finished={[c['finished'] for c in ctx2]} "
          f"knobs {sorted({tuple(sorted(p.items())) for p in decisions2})}")
    check(st2["explores"] == 0 and all(c["finished"] for c in ctx2)
          and all(p == drec.point for p in decisions2),
          "the second router did not exact-hit the committed decode record")
    route_launches = counts()
    phase_launches["route"] = route_launches
    print(f"[6] route launches: {route_launches}")
    check(route_launches["decode_attention"] == ROUTE_CALLS["decode_attention"] + 20,
          f"routed decode calls did not each launch the kernel once: {route_launches}")
    check(all(route_launches[n] == c for n, c in ROUTE_CALLS.items() if n != "decode_attention"),
          f"routed calls did not each launch their kernel once: {route_launches}")
    check(repeat_equal[0], "a routed output differs from an earlier one at the same knobs")
    for (name, knobs), got in served.items():
        ca, kw = call_args[name]
        want = get_spec(name).fn(*ca, **kw, **dict(knobs))
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(_tensors(got), _tensors(want)))
        print(f"[6] routed {name} at {dict(knobs)}: bit_equal={equal} (against the kernel at those knobs)")
        check(equal, f"routed {name} output differs from the kernel at {dict(knobs)}")
    del served, router, router2

    # -------------------------------------------------------------- 7. times
    def cuda_ms(fn, reps: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    k_exp = k.repeat_interleave(H // Kh, dim=1)  # GQA expanded for the library call
    v_exp = v.repeat_interleave(H // Kh, dim=1)
    q_bhsd = q.transpose(1, 2)
    g_da = dH // dKh
    dk_exp, dv_exp = dk.repeat_interleave(g_da, dim=1), dv.repeat_interleave(g_da, dim=1)
    dmask = (dvalid > 0)[:, None, None, :]  # SDPA takes True = attend
    timing = {
        "matmul": dict(
            default=lambda: ops.matmul(a, b, **defaults["matmul"]),
            tuned=lambda: ops.matmul(a, b, **records["matmul"].point),
            plain=lambda: mm.matmul_plain(a, b, **records["matmul"].point),
            library=lambda: torch.matmul(a, b),
        ),
        "flash_attention": dict(
            default=lambda: ops.flash_attention(q, k, v, causal=True, **defaults["flash_attention"]),
            tuned=lambda: ops.flash_attention(q, k, v, causal=True, **records["flash_attention"].point),
            plain=lambda: fa.flash_attention_plain(q_bhsd, k, v, causal=True,
                                                   **records["flash_attention"].point),
            library=lambda: F.scaled_dot_product_attention(q_bhsd, k_exp, v_exp, is_causal=True),
        ),
        "decode_attention": dict(
            default=lambda: ops.decode_attention(*da_args, **defaults["decode_attention"]),
            tuned=lambda: ops.decode_attention(*da_args, **records["decode_attention"].point),
            plain=lambda: da.decode_attention_plain(*da_args, **records["decode_attention"].point),
            library=lambda: F.scaled_dot_product_attention(dq[:, :, None], dk_exp, dv_exp,
                                                           attn_mask=dmask),
        ),
        "lru_scan": dict(
            default=lambda: ops.lru_scan(*lru_args, **defaults["lru_scan"]),
            tuned=lambda: ops.lru_scan(*lru_args, **records["lru_scan"].point),
            main_path=lambda: ops.lru_scan(*lru_args, chunk=4),
            plain=lambda: ls.lru_scan_plain(*lru_args, **records["lru_scan"].point),
            library=None,  # no single PyTorch call computes the scan
        ),
        "rwkv_scan": dict(
            default=lambda: ops.rwkv_scan(*rwkv_args, **defaults["rwkv_scan"]),
            tuned=lambda: ops.rwkv_scan(*rwkv_args, **records["rwkv_scan"].point),
            main_path=lambda: ops.rwkv_scan(*rwkv_args, chunk=4),
            plain=lambda: ls.rwkv_scan_plain(*rwkv_args, **records["rwkv_scan"].point),
            library=None,
        ),
    }
    designs = {}
    for name, module in (("matmul", mm), ("flash_attention", fa)):
        for which in ("default", "tuned"):
            _, design = ran(module, timing[name][which])
            designs[(name, which)] = design
            print(f"[7] {name} {which} call ran the {design} design")
            check(design == "wgmma", f"the {which} {name} call at the main shape ran {design}, not wgmma")
    times = {}
    for name, t in timing.items():
        ca, kw = call_args[name]
        terms = roofline(name, *ca, **kw)
        row = {"default": cuda_ms(t["default"], 5), "tuned": cuda_ms(t["tuned"], 5),
               "plain": cuda_ms(t["plain"], 1 if name in ("lru_scan", "rwkv_scan") else 3),
               "library": cuda_ms(t["library"], 20) if t["library"] is not None else None,
               "main_path": cuda_ms(t["main_path"], 5) if "main_path" in t else None,
               "terms": terms}
        times[name] = row
        bound_ms = terms.bound_s * 1e3
        lib = f"{row['library']:.4f} ms" if row["library"] is not None else "none"
        mp = f", serving chunk=4 {row['main_path']:.4f} ms" if row["main_path"] is not None else ""
        print(f"[7] {name}: default {row['default']:.4f} ms {defaults[name]}, tuned "
              f"{row['tuned']:.4f} ms {records[name].point}{mp}, plain {row['plain']:.4f} ms, "
              f"library {lib}, bound {bound_ms:.4f} ms by {terms.dominant} "
              f"({terms.flops / 1e9:.1f} GFLOP, {terms.bytes_accessed / 1e6:.1f} MB; "
              f"{bound_ms / row['tuned']:.4f} of the roofline tuned); launches by phase: "
              f"tune {phase_launches['tune'][name]}, replay {phase_launches['replay'][name]}, "
              f"pretune {phase_launches['pretune'][name]}, route {phase_launches['route'][name]}")
    # the two kernels redesigned for the card: split count and grid, share of
    # the bytes bound, decode against SDPA and the rwkv tensor-core design
    # against the per-token design on the same inputs (its C entry point)
    d_row = times["decode_attention"]
    d_bytes_ms = d_row["terms"].memory_s * 1e3
    for which in ("default", "tuned"):
        knobs = defaults["decode_attention"] if which == "default" else records["decode_attention"].point
        nsplit, grid_ = split_of(da_args, knobs)
        d_row[f"splits_{which}"], d_row[f"grid_{which}"] = nsplit, list(grid_)
        print(f"[7] decode_attention {which} {knobs}: {d_row[which]:.4f} ms, {nsplit} splits, grid "
              f"{grid_} = {math.prod(grid_)} blocks on {n_sm} SMs, {d_bytes_ms / d_row[which]:.4f} of "
              f"the bytes bound {d_bytes_ms:.4f} ms; SDPA {d_row['library']:.4f} ms: "
              f"{'faster' if d_row[which] < d_row['library'] else 'SLOWER'} than SDPA "
              f"({d_row['library'] / d_row[which]:.2f}x)")
    r_row, r_terms = times["rwkv_scan"], times["rwkv_scan"]["terms"]
    tc_tensor, tc_cuda = ls.rwkv_tc_flops(rB, rT, rH)
    r_row["tc_bound_ms"] = max(r_terms.memory_s, tc_tensor / 495e12, tc_cuda / 67e12) * 1e3
    r_row["bytes_bound_ms"] = r_terms.memory_s * 1e3
    r_row["per_token"] = {}
    for label, chunk in (("serving chunk=4", 4), (f"tuned chunk={records['rwkv_scan'].point['chunk']}",
                                                   records["rwkv_scan"].point["chunk"])):
        _, design = ran(ls, lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk))
        tc_ms = cuda_ms(lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk), 5)
        pt_ms = cuda_ms(lambda: ls._rwkv_launch(*rwkv_args, chunk, "per_token"), 5)
        tc_ms2 = cuda_ms(lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk), 5)
        r_row["per_token"][chunk] = pt_ms
        print(f"[7] rwkv_scan {label}: {design} design {tc_ms:.4f} / {tc_ms2:.4f} ms, per_token "
              f"design {pt_ms:.4f} ms on the same inputs ({pt_ms / min(tc_ms, tc_ms2):.2f}x); "
              f"{r_row['bytes_bound_ms'] / min(tc_ms, tc_ms2):.4f} of the bytes bound "
              f"{r_row['bytes_bound_ms']:.4f} ms ({r_terms.bytes_accessed / 1e6:.1f} MB); tensor-core "
              f"design's bound {r_row['tc_bound_ms']:.4f} ms ({tc_tensor / 1e9:.1f} GFLOP TF32, "
              f"{tc_cuda / 1e9:.2f} GFLOP fp32); fp32 operations bound of the per-token design "
              f"{r_terms.compute_s * 1e3:.4f} ms")
        check(design == "tc", f"rwkv_scan {label} at the serving shape ran {design}, not tc")
    l_row = times["lru_scan"]
    l_bytes_ms = l_row["terms"].memory_s * 1e3
    l_row["segments"] = {}
    for which, knobs in (("default", defaults["lru_scan"]), ("tuned", records["lru_scan"].point),
                         ("main_path", {"chunk": 4})):
        nseg = lru_segments(lru_args, knobs)
        l_row["segments"][which] = nseg
        blocks = LRU_SHAPE[0] * (LRU_SHAPE[2] // knobs.get("block_d", ls.LRU_BLOCK_D)) * nseg
        print(f"[7] lru_scan {'serving' if which == 'main_path' else which} {knobs}: "
              f"{l_row[which]:.4f} ms, segmented: {nseg} segments of {LRU_SHAPE[1] // nseg} steps, "
              f"{blocks} blocks on {n_sm} SMs, {l_bytes_ms / l_row[which]:.4f} of the bytes bound "
              f"{l_bytes_ms:.4f} ms")
    # the scans' backward kernels at the trained shapes: the kernel, its
    # plain version and the eager oracle
    # the port's backward ran before (autograd through ref.*_scan_ref); no
    # single PyTorch call computes either (library: none)
    def oracle_bwd(oracle, inputs, cotangents):
        leaves = [t_.detach().requires_grad_(True) for t_ in inputs]
        with torch.enable_grad():
            return torch.autograd.grad(oracle(*leaves), leaves, cotangents)

    for name, args_, n_in, plain, oracle, work in (
            ("lru_scan_bwd", lb_args, 3, lambda: ls.lru_scan_bwd_plain(*lb_args, **lb_knobs),
             ref.lru_scan_ref, ls.lru_bwd_flops_bytes),
            ("rwkv_scan_bwd", rb_args, 6, lambda: ls.rwkv_scan_bwd_plain(*rb_args),
             ref.rwkv_scan_ref, ls.rwkv_bwd_flops_bytes)):
        terms = roofline_terms(*work(*args_[:n_in]), "float32", H100_SXM)
        kernel = (lambda a_=args_, n_=name: bwd_calls[n_](a_))
        row = {"tuned": cuda_ms(kernel, 5), "plain": cuda_ms(plain, 1),
               "oracle": cuda_ms(lambda: oracle_bwd(oracle, args_[:n_in], args_[n_in:]), 1),
               "library": None, "main_path": None, "terms": terms}
        row["tuned_again"] = cuda_ms(kernel, 5)
        row["default"] = row["tuned"]
        # the kernels' own time, without the wrapper's host work (which the
        # events above include when it outlasts the kernel): device-busy ms
        # a call over 20 traced calls
        row["device_ms"] = trace_busy(out, kernel, 20, f"{name}_device")[0]
        times[name] = row
        bound_ms = terms.bound_s * 1e3
        print(f"[7] {name} {f'fp32 {LRU_BWD_SHAPE} ({lb_design})' if name == 'lru_scan_bwd' else f'bf16 {RWKV_BWD_SHAPE}, {rb_slices} slices'}: "
              f"{row['tuned']:.4f} / {row['tuned_again']:.4f} ms (CUDA events through the wrapper), device "
              f"{row['device_ms']:.4f} ms a call ({bound_ms / row['device_ms']:.4f} of the roofline), plain {row['plain']:.2f} ms, eager "
              f"oracle (autograd through ref) {row['oracle']:.2f} ms, library none, bound {bound_ms:.4f} ms "
              f"by {terms.dominant} ({terms.flops / 1e9:.2f} GFLOP fp32, {terms.bytes_accessed / 1e6:.1f} "
              f"MB; {bound_ms / min(row['tuned'], row['tuned_again']):.4f} of the roofline); {smi}")
    # flash attention's backward kernel at phase 2's bf16 shapes: the kernel,
    # its plain version, the eager oracle the port's backward ran before
    # (autograd through ref.flash_attention_ref) and SDPA's backward with the
    # KV heads expanded (torch.autograd.grad through
    # scaled_dot_product_attention; a yardstick the port never calls)
    fb_rows = {}
    for label, shape, dtype, causal in FA_BWD_CASES:
        if dtype != "bfloat16":
            continue
        q_, k_, v_, o_, lse_, do_ = fb_args[label]
        g_ = q_.shape[1] // k_.shape[1]
        terms = roofline_terms(*fa.bwd_flops_bytes(q_, k_, v_, causal), "bfloat16", H100_SXM)
        kernel = (lambda a_=fb_args[label], c_=causal: fa.flash_attention_bwd(*a_, causal=c_))
        sq_, sk_, sv_ = (t_.detach().clone().requires_grad_(True)
                         for t_ in (q_, k_.repeat_interleave(g_, 1), v_.repeat_interleave(g_, 1)))
        so_ = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=causal)
        row = {"tuned": cuda_ms(kernel, 5),
               "plain": cuda_ms(lambda a_=fb_args[label], c_=causal: fa.flash_attention_bwd_plain(*a_, causal=c_), 1),
               "oracle": cuda_ms(lambda: oracle_bwd(lambda q__, k__, v__: ref.flash_attention_ref(
                   q__, k__, v__, causal=causal), (q_.transpose(1, 2), k_, v_), do_.transpose(1, 2)), 1),
               "library": cuda_ms(lambda: torch.autograd.grad(so_, (sq_, sk_, sv_), do_, retain_graph=True), 5),
               "main_path": None, "terms": terms, "shape": list(shape), "causal": causal}
        row["tuned_again"] = cuda_ms(kernel, 5)
        row["default"] = row["tuned"]
        _, row["design"] = ran(fa, kernel)
        row["head_splits"] = fa_splits(q_, k_) if row["design"] == "bwd_wgmma" else 1
        del sq_, sk_, sv_, so_
        fb_rows[label] = row
        bound_ms = terms.bound_s * 1e3
        best = min(row["tuned"], row["tuned_again"])
        print(f"[7] flash_attention_bwd bf16 {label} q{tuple(q_.shape)} kv{tuple(k_.shape)} causal={causal} "
              f"({row['design']} design, {row['head_splits']} head splits): {row['tuned']:.4f} / "
              f"{row['tuned_again']:.4f} ms, plain {row['plain']:.2f} ms, "
              f"eager oracle (autograd through ref) {row['oracle']:.2f} ms, SDPA backward {row['library']:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {terms.dominant} ({terms.flops / 1e9:.1f} GFLOP in five products, "
              f"{terms.bytes_accessed / 1e6:.1f} MB; {bound_ms / best:.4f} of the roofline, "
              f"{best / row['library']:.2f}x SDPA's backward, {row['oracle'] / best:.1f}x faster than the "
              f"oracle); {smi}")
    times["flash_attention_bwd"] = {**fb_rows["seamless encoder"], "qwen2_7b": fb_rows["qwen2-7b layer"]}
    csa_nm_ms = cuda_ms(lambda: ops.decode_attention(*da_args, **records_csa_nm.point), 5)
    print(f"[7] decode_attention tuned by csa+nm: {csa_nm_ms:.4f} ms {records_csa_nm.point}; "
          f"by the route: {drec.point}")
    # recurrentgemma-2b's MQA decode: K and V are 16.8 MB, so they stay in the 50 MB L2
    # between repetitions (the times below are warm-L2 times)
    rg_terms = roofline("decode_attention", *rg_args)
    rg_defaults = get_spec("decode_attention").defaults(*rg_args)
    rg_k_exp = rg_args[1].repeat_interleave(gH // gKh, dim=1)
    rg_v_exp = rg_args[2].repeat_interleave(gH // gKh, dim=1)
    rg_mask = (rg_args[3] > 0)[:, None, None, :]
    rg_row = {"default": cuda_ms(lambda: ops.decode_attention(*rg_args, **rg_defaults), 20),
              "plain": cuda_ms(lambda: da.decode_attention_plain(*rg_args, **rg_defaults), 3),
              "library": cuda_ms(lambda: F.scaled_dot_product_attention(
                  rg_args[0][:, :, None], rg_k_exp, rg_v_exp, attn_mask=rg_mask), 20)}
    times["decode_attention"]["rg_mqa"] = rg_row
    print(f"[7] decode_attention recurrentgemma-2b MQA q{tuple(rg_args[0].shape)} "
          f"kv{tuple(rg_args[1].shape)}: default {rg_row['default']:.4f} ms {rg_defaults}, plain "
          f"{rg_row['plain']:.4f} ms, library {rg_row['library']:.4f} ms, bound "
          f"{rg_terms.bound_s * 1e3:.4f} ms by {rg_terms.dominant} "
          f"({rg_terms.bytes_accessed / 1e6:.1f} MB: inside the 50 MB L2, warm between repetitions)")
    # the seamless encoder's flash call alone (the shape phase 12 serves):
    # non-causal at head dim 64, at the default tiles and tuned (its own DB,
    # after the main paths' counts were read), against its plain version
    # at the default tiles, SDPA and its bound
    eB, eS, eH, eKh, ehd = ENC_FA_SHAPE
    eq = randn((eB, eS, eH, ehd), torch.bfloat16)
    ek = randn((eB, eKh, eS, ehd), torch.bfloat16)
    ev = randn((eB, eKh, eS, ehd), torch.bfloat16)
    eq_bhsd = eq.transpose(1, 2)
    e_def = get_spec("flash_attention").defaults(eq, ek, ev, causal=False)
    e_want = fa.flash_attention_plain(eq_bhsd, ek, ev, causal=False, **e_def).transpose(1, 2)
    e_label = f"flash_attention bf16 seamless encoder q{tuple(eq.shape)} kv{tuple(ek.shape)} causal=False"
    got, design = ran(fa, lambda: ops.flash_attention(eq, ek, ev, causal=False, **e_def))
    compare(f"{e_label} {e_def} ({design})", "flash_attention", got, e_want, phase=7)
    check(design == "wgmma", f"the encoder-shape flash call at its default tiles ran {design}, not wgmma")
    t0 = time.perf_counter()
    e_rec = tune_call("flash_attention", eq, ek, ev, causal=False,
                      db=TuningDB(str(out / "tune_encoder.json")))
    check(e_rec is not None and math.isfinite(e_rec.cost), "tune_call at the encoder shape committed nothing")
    print(f"[7] tune_call flash_attention at the encoder shape: point={e_rec.point} "
          f"cost={e_rec.cost * 1e3:.4f}ms evals={e_rec.evals} ({time.perf_counter() - t0:.1f}s)")
    got, e_design = ran(fa, lambda: ops.flash_attention(eq, ek, ev, causal=False, **e_rec.point))
    compare(f"{e_label} tuned {e_rec.point} ({e_design}) vs the plain version at {e_def}",
            "flash_attention", got, e_want, phase=7)
    del got, e_want
    e_terms = roofline("flash_attention", eq, ek, ev, causal=False)
    enc = {"default": cuda_ms(lambda: ops.flash_attention(eq, ek, ev, causal=False, **e_def), 5),
           "tuned": cuda_ms(lambda: ops.flash_attention(eq, ek, ev, causal=False, **e_rec.point), 5),
           "plain": cuda_ms(lambda: fa.flash_attention_plain(eq_bhsd, ek, ev, causal=False, **e_def), 1),
           "library": cuda_ms(lambda: F.scaled_dot_product_attention(eq_bhsd, ek, ev), 20),
           "terms": e_terms, "knobs_default": e_def, "knobs": e_rec.point, "design": e_design}
    times["flash_attention"]["encoder"] = enc
    e_bound = e_terms.bound_s * 1e3
    print(f"[7] flash_attention seamless encoder shape q{tuple(eq.shape)} kv{tuple(ek.shape)} "
          f"causal=False: default {enc['default']:.4f} ms {e_def} (wgmma), tuned {enc['tuned']:.4f} ms "
          f"{e_rec.point} ({e_design}), plain {enc['plain']:.4f} ms, SDPA {enc['library']:.4f} ms, bound "
          f"{e_bound:.4f} ms by {e_terms.dominant} ({e_terms.flops / 1e9:.1f} GFLOP, "
          f"{e_terms.bytes_accessed / 1e6:.1f} MB; bytes alone {e_terms.memory_s * 1e3:.4f} ms); "
          f"{e_bound / enc['default']:.4f} of the bound at the default tiles, "
          f"{enc['default'] / enc['library']:.2f}x SDPA")
    del eq, ek, ev, eq_bhsd
    del a, b, q, k, v, k_exp, v_exp, q_bhsd, lru_a, lru_b, lru_h0, rr, rk, rv, rlw, ru, rs0
    del dq, dk, dv, dvalid, dk_exp, dv_exp, dmask, rg_args, rg_k_exp, rg_v_exp, small_da
    del call_args, lru_args, rwkv_args, da_args, timing, lb_args, rb_args, fb_args
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------- main path 4: training, 10-11
    # in a child process, before serving: a full-width model's fp32 weights,
    # gradients and AdamW state need most of the card, and this process
    # keeps what its caching allocator holds until it exits
    # AdamW at seamless-m4t-large-v2's 726 leaves, 26.1 GB of fp32 p, g, m, v
    aw_row = adamw_times(dev, gen, cuda_ms)
    times["adamw"] = aw_row
    aw_bound = aw_row["terms"].bound_s * 1e3
    print(f"[7] adamw at {ADAMW_CELL}'s {aw_row['leaves']} leaves ({aw_row['parameters'] / 1e9:.3f} B fp32 "
          f"parameters): {aw_row['tuned']:.4f} ms an update ({aw_row['launches_per_update']} launches), plain "
          f"loop {aw_row['plain']:.2f} ms, torch._fused_adamw_ {aw_row['library']:.4f} ms (no clip), bound "
          f"{aw_bound:.4f} ms by {aw_row['terms'].dominant} ({aw_row['terms'].bytes_accessed / 1e9:.1f} GB: 32 "
          f"bytes a parameter; {aw_bound / aw_row['tuned']:.4f} of the roofline); {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    live_cuda_report("7", dev)

    def child(flag: str, result: str, timeout: int, what: str) -> dict:
        """Run this script as a child process for ``flag``; its output is
        printed, its last line (``result`` + JSON) returned."""
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag, "--out", str(out)],
                              capture_output=True, text=True, cwd=str(ROOT), timeout=timeout)
        got_ = None
        for line in proc.stdout.splitlines():
            if line.startswith(result):
                got_ = json.loads(line[len(result):])
            else:
                print(line)
        if proc.returncode != 0 or got_ is None:
            print(proc.stderr[-6000:], file=sys.stderr)
        check(proc.returncode == 0 and got_ is not None, f"the {what} failed (exit {proc.returncode})")
        return got_

    train_launches = child("--train-phases", TRAIN_RESULT, TRAIN_TIMEOUT_S, "training phases")

    # ------------------------------ main path 5: the families served, 12-15
    # a child process too: moonshot-v1-16b-a3b's weights alone are 56 GB
    family_launches = child("--family-phases", FAMILY_RESULT, FAMILY_TIMEOUT_S, "family phases")

    # ----------------------------- main path 6: the parallel layer, 16-18
    # 16-17 in a child process (the fleet race, the collectives, the
    # compressed data-parallel step, the pipeline on a one-rank NCCL group)
    parallel_launches = child("--parallel-phases", PARALLEL_RESULT, PARALLEL_TIMEOUT_S,
                              "parallel phases")
    # 18. the training launcher's --distributed path under torchrun, started
    # from this process once the child has exited: recurrentgemma-2b at full
    # width needs most of the card (phase 10 peaks at 68 GB)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[18] before torchrun: this process holds torch.cuda.memory_reserved "
          f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB; {smi}")
    # phase 10's arguments and tuning DB: an exact hit, so the steps run the
    # microbatch count phase 10's run 2 ran, and the first loss is its first
    dist_args = ["--distributed", "--arch", TRAIN_ARCH, "--steps", str(DIST_STEPS),
                 "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
                 "--tune", "--db", str(out / "train.json")]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"), "--out", str(out),
                           "--distributed-train", *dist_args],
                          capture_output=True, text=True, cwd=str(ROOT), timeout=DIST_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    dist_wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    tail = [i_ for i_, ln in enumerate(lines) if ln.startswith(DIST_RESULT)]
    if proc.returncode != 0 or not tail:
        print(proc.stdout[-4000:])
        print(proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0 and bool(tail),
          f"torchrun launch.train --distributed failed (exit {proc.returncode})")
    rank_out = json.loads(lines[tail[0]][len(DIST_RESULT):])
    dist_launches = rank_out["launches"]
    first = next(i_ for i_, ln in enumerate(lines) if ln.startswith("{"))
    summary = dict(json.loads("\n".join(lines[first:tail[0]])), loss=rank_out["loss"])
    rg10 = json.loads((out / "train_report.json").read_text())[TRAIN_ARCH]["2"]
    ref_loss, ref_mb = rg10["loss"][0], rg10["final_knobs"]["microbatches"]
    hit = "tuning db hit: train_step/" in proc.stdout
    print(f"[18] torchrun --standalone --nproc_per_node 1 repro_torch.launch.train {' '.join(dist_args)} "
          f"(NCCL, cuda:LOCAL_RANK): {summary['steps']} steps in {dist_wall:.1f}s wall (process start "
          f"and model build included), tuning db hit {hit} {summary['final_knobs']}, loss per step "
          f"{summary['loss']}, mean step {summary['mean_step_s'] * 1e3:.1f} ms; first loss against "
          f"phase 10's run 2 (the same DB hit, {ref_mb} microbatch(es)): {ref_loss}, bit-equal "
          f"{summary['loss'][0] == ref_loss}; launches {dist_launches}; {smi}")
    check(hit and summary["final_knobs"] == rg10["final_knobs"],
          f"launch.train --distributed did not adopt phase 10's tuning record: {summary['final_knobs']}")
    check(summary["loss"][0] == ref_loss, f"launch.train --distributed's first loss {summary['loss'][0]} "
          f"is not phase 10's {ref_loss}")
    per_run = RG_LRU_LAYERS * ref_mb * DIST_STEPS
    check(dist_launches["lru_scan"] == per_run and dist_launches["lru_scan_bwd"] == per_run
          and not any(other_launches(dist_launches, "lru_scan", "lru_scan_bwd").values())
          and adamw_updates(dist_launches, configs.get(TRAIN_ARCH), "launch.train --distributed") == DIST_STEPS,
          f"launch.train --distributed launched {dist_launches}, expected lru_scan {RG_LRU_LAYERS} x "
          f"{ref_mb} microbatches x {DIST_STEPS} steps (the forward), lru_scan_bwd as many, one AdamW "
          f"update a step and nothing else")
    for name in COUNTERS:
        parallel_launches[name] += dist_launches[name]
    # pretune --launch: host arithmetic on the H100 data sheet, no kernel
    for run in (1, 2):
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pretune.main(["--launch", "--cost", "analytic", "--smoke", "--devices", "8",
                               "--db", str(out / "pretune_launch.json")])
        for line in buf.getvalue().splitlines():
            print(f"[18] pretune --launch run {run}: {line}")
        want = "(0 exact hits, 3 searched)" if run == 1 else "(3 exact hits, 0 searched)"
        check(rc == 0 and f"3 launch contexts tuned {want}" in buf.getvalue(),
              f"pretune --launch run {run} did not report {want}")
        check(not any(counts().values()), f"pretune --launch launched a kernel: {counts()}")
    print("[18] pretune --launch --cost analytic: the launch cost model on the h100-sxm data sheet, "
          f"host arithmetic: no kernel launched (its costs are modelled seconds, not times on {smi})")
    print(f"[18] parallel launches: {parallel_launches}; {smi}")

    # ------------------------------------------ main path 3: serving, 8-9
    decode_profiles = {}
    serve_launches = {}
    plain_scan = {"lru_scan": ls.lru_scan_plain, "rwkv_scan": ls.rwkv_scan_plain}

    def serve_phase(phase, arch, scan, per_prefill):
        """One served model (phases 8-9); every tensor it made dies with
        its locals when it returns."""
        db_path = str(out / f"serve_{arch}.json")
        runs = []
        for run in (1, 2):
            reset_counts()
            by_design = dict(ls.launches_by_design)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = serve.serve(["--arch", arch, *SERVE_ARGS, "--db", db_path])
            launched = counts()
            by_design = {d: n - by_design[d] for d, n in ls.launches_by_design.items()}
            for line in buf.getvalue().splitlines():
                print(f"[{phase}] {arch} run {run}: {line}")
            print(f"[{phase}] {arch} run {run}: prefill {res['prefill_ms']:.1f} ms, decode "
                  f"{res['decode_tok_s']:.1f} tok/s, k={res['k']}, db_hit={res['db_hit']}, "
                  f"launches {launched}")
            check(launched[scan] == per_prefill,
                  f"{arch} run {run}: {scan} launched {launched[scan]} times in one prefill, "
                  f"expected {per_prefill} (one per layer)")
            check(all(n == 0 for name, n in launched.items() if name != scan),
                  f"{arch} run {run}: unexpected launches {launched}")
            if scan == "rwkv_scan":
                print(f"[{phase}] {arch} run {run}: rwkv_scan launches by design {by_design}")
                check(by_design["tc"] == per_prefill,
                      f"{arch} run {run}: the prefill's rwkv_scan calls ran {by_design}, "
                      f"not {per_prefill} of the tensor-core design")
            h = res["hidden"]
            check(h.shape == (8, res["model"].cfg.d_model) and bool(torch.isfinite(h.float()).all()),
                  f"{arch} run {run}: prefill hidden {tuple(h.shape)} not finite of width d_model")
            check(run == 1 or res["db_hit"], f"{arch} run 2 was not a tuning DB hit")
            captures = res["graphs"].captures
            print(f"[{phase}] {arch} run {run}: {captures} decode depths captured as CUDA graphs; "
                  f"router {res.get('router')}")
            check(captures >= (len(serve.DECODE_KS) if run == 1 else 1),
                  f"{arch} run {run}: decode captured {captures} CUDA graphs")
            check(res["router"]["inband_builds"] == 0 and res["router"]["candidate_failures"] == 0,
                  f"{arch} run {run}: a decode build ran in-band or failed")
            for name, n in launched.items():
                serve_launches[name] = serve_launches.get(name, 0) + n
            runs.append({key: res[key] for key in ("prefill_ms", "decode_tok_s", "k", "db_hit")})
            if run == 1:
                h_first = h.clone()
                del res, h
                gc.collect()
                torch.cuda.empty_cache()
        check(torch.equal(h_first, h), f"{arch}: the two runs' prefills differ")

        # the served model, kernel path against plain path (launches made
        # here are checks, not the main path: the counts were read above)
        model, batch = res["model"], res["batch"]
        cfg = model.cfg
        by_dtype: dict = {}
        for prm in model.parameters():
            key = str(prm.dtype).replace("torch.", "")
            by_dtype[key] = by_dtype.get(key, 0) + prm.numel() * prm.element_size()
        print(f"[{phase}] {arch} weights: "
              f"{', '.join(f'{k_} {v_ / 1e9:.3f} GB' for k_, v_ in sorted(by_dtype.items()))}; "
              f"{sum(p_.numel() for p_ in model.parameters()) / 1e9:.3f} B parameters; "
              f"torch.cuda.memory_allocated {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB")
        model.exec_cfg = ExecConfig(attn_impl="xla", rec_chunk=4)
        h_bf16_plain, _ = model.prefill(batch)
        err_bf16 = (h.float() - h_bf16_plain.float()).abs()
        print(f"[{phase}] {arch} bf16 as served, kernel path vs plain path: max |dh| "
              f"{err_bf16.max().item():.4e}, mean {err_bf16.mean().item():.4e}, max |h| "
              f"{h_bf16_plain.float().abs().max().item():.4f} (rounding spread, not held)")
        # the served instantiation on served data: the last layer's scan
        # inputs from one more prefill on the kernel path, in the dtypes the
        # model passes them (rwkv: bf16 r, k, v), kernel against plain version
        served_call, real_scan = {}, getattr(ops, scan)

        def capture(*scan_args, **scan_kw):
            served_call["args"] = [t_.detach().clone() for t_ in scan_args]
            served_call["kw"] = dict(scan_kw, interpret=False)
            return real_scan(*scan_args, **scan_kw)

        model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=4)
        setattr(ops, scan, capture)
        try:
            model.prefill(batch)
        finally:
            setattr(ops, scan, real_scan)
        s_args, s_kw = served_call["args"], served_call["kw"]
        plain_kw = {k_: v_ for k_, v_ in s_kw.items() if k_ != "interpret"}
        label = (f"{scan} on the last layer's served inputs "
                 f"({', '.join(f'{tuple(t_.shape)} {str(t_.dtype)[6:]}' for t_ in s_args)}) {plain_kw}")
        if scan == "lru_scan":
            lru_compare(label, s_args, plain_kw, got=real_scan(*s_args, **s_kw), phase=phase)
        else:
            compare(label, scan, real_scan(*s_args, **s_kw), plain_scan[scan](*s_args, **plain_kw),
                    phase=phase)
        del res, h, h_first, h_bf16_plain, err_bf16, served_call, s_args
        gc.collect()
        torch.cuda.empty_cache()
        decode_profiles[arch] = decode_profile(out, phase, arch, model, batch)
        gc.collect()
        torch.cuda.empty_cache()
        model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
        hidden32 = {}
        for impl in ("cuda", "xla"):
            model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=4)
            hidden32[impl], _ = model.prefill(batch)
            gc.collect()
            torch.cuda.empty_cache()
        hk, hp = hidden32["cuda"], hidden32["xla"]
        err = (hk - hp).abs().max().item()
        ok = hk.dtype == torch.float32 and bool(torch.allclose(hk, hp, atol=HIDDEN_TOL, rtol=HIDDEN_TOL))
        print(f"[{phase}] {arch} fp32 arithmetic on the served weights, kernel path vs plain "
              f"path: max |dh| {err:.4e}, max |h| {hp.abs().max().item():.4f}, "
              f"allclose(atol={HIDDEN_TOL:g}, rtol={HIDDEN_TOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), f"{arch}: kernel path disagrees with the plain path")
        print(f"[{phase}] {arch} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, "
              f"decode tok/s {[round(r['decode_tok_s'], 1) for r in runs]} "
              f"(batch 8, prompt 2048, 64 new tokens; {smi})")
        del model, batch, hidden32, hk, hp

    for phase, (arch, scan, per_prefill) in enumerate(SERVE, start=8):
        serve_phase(phase, arch, scan, per_prefill)
        gc.collect()
        torch.cuda.empty_cache()  # free the first model before the second loads

    (out / "decode_profile.json").write_text(json.dumps(decode_profiles, indent=1))
    print(f"[9] serving launches: {serve_launches}")

    # what serving leaves allocated (PERF.md §7)
    live_cuda_report("9", dev)
    main_launches = {n: tuning_launches[n] + route_launches[n] + serve_launches.get(n, 0)
                     + train_launches[n] + family_launches[n] + parallel_launches[n] for n in KERNELS}
    print(f"[11] training launches: {train_launches}; families' serving launches: {family_launches}; "
          f"parallel launches: {parallel_launches}; "
          f"all main paths: {main_launches}; launches by "
          f"design since the start: matmul {mm.launches_by_design}, flash_attention {fa.launches_by_design}, "
          f"decode_attention {da.launches_by_design}, rwkv_scan {ls.launches_by_design}")
    for name, n in main_launches.items():
        check(n > 0, f"no main path launched the {name} kernel")

    sources = {"matmul": ("src/repro_torch/kernels/csrc/matmul_wgmma.cu", "src/repro/kernels/matmul.py:40"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                                   "src/repro/kernels/flash_attention.py:79"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:58"),
               "lru_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                            "src/repro/kernels/linear_scan.py:147"),
               "rwkv_scan": ("src/repro_torch/kernels/csrc/rwkv_subchunk.cu",
                             "src/repro/kernels/linear_scan.py:77"),
               # no Pallas counterpart: the JAX package's custom_vjp takes
               # jax.vjp of its per-token lax.scan (kernels/ops.py)
               "lru_scan_bwd": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                                "src/repro/kernels/ops.py:98"),
               "rwkv_scan_bwd": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                                 "src/repro/kernels/ops.py:74"),
               # no Pallas counterpart: jax.vjp of the oracle (kernels/ops.py)
               "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                       "src/repro/kernels/ops.py:43"),
               # no Pallas counterpart: XLA fuses the optimizer's elementwise chain under jit
               "adamw": ("src/repro_torch/kernels/csrc/adamw.cu", "src/repro/optim/__init__.py:59")}
    train_report = json.loads((out / "train_report.json").read_text())
    kernels = []
    for name in KERNELS:
        row = times[name]
        terms = row["terms"]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "design": designs.get((name, "tuned"), "simt"),
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "launches_by_path": {"tune": phase_launches["tune"][name],
                                 "replay": phase_launches["replay"][name],
                                 "pretune": phase_launches["pretune"][name],
                                 "route": route_launches[name],
                                 "serving": serve_launches.get(name, 0),
                                 "train": train_launches[name],
                                 "serving_families": family_launches[name],
                                 "parallel": parallel_launches[name]},
            "ms": row["tuned"], "ms_default": row["default"], "plain_ms": row["plain"],
            "bound_ms": terms.bound_s * 1e3, "bound_by": terms.dominant,
            "library_ms": row["library"],
        }
        if name == "rwkv_scan":  # the tensor-core design ran; its bound is the bytes'
            entry.update(design="tc", bound_ms=row["tc_bound_ms"], bound_by="bytes",
                         fp32_operations_bound_ms=terms.compute_s * 1e3,
                         per_token_ms={str(c): t for c, t in row["per_token"].items()},
                         per_token_source="src/repro_torch/kernels/csrc/linear_scan.cu")
        if name in ("lru_scan_bwd", "rwkv_scan_bwd"):
            entry.update(design="fused_segmented" if name == "lru_scan_bwd" else "row_slices_cluster",
                         shape=list(LRU_BWD_SHAPE if name == "lru_scan_bwd" else RWKV_BWD_SHAPE),
                         ms=min(row["tuned"], row["tuned_again"]), ms_default=None, device_ms=row["device_ms"],
                         oracle_ms=row["oracle"], kernels_per_call_by_T=bwd_kernel_counts[name],
                         pallas_counterpart=None)
            if name == "rwkv_scan_bwd":
                entry["slices"] = rb_slices
            else:
                entry["tiling"] = lb_tiling._asdict()
        if name == "flash_attention_bwd":  # seamless's encoder shape; qwen2-7b's layer beside it
            qrow = row["qwen2_7b"]
            entry.update(design=row["design"].removeprefix("bwd_"), head_splits=row["head_splits"],
                         shape=row["shape"], causal=row["causal"],
                         ms=min(row["tuned"], row["tuned_again"]), ms_default=None, oracle_ms=row["oracle"],
                         kernels_per_call_by_S=bwd_kernel_counts[name], pallas_counterpart=None,
                         train_by_family={"qwen2_7b_2_layers": train_report["qwen2_7b_2_layers"]["cuda"]["bwd_wgmma"],
                                          **train_report["families"]["flash_bwd_launches"]},
                         qwen2_7b_shape={"shape": qrow["shape"], "causal": qrow["causal"],
                                         "ms": min(qrow["tuned"], qrow["tuned_again"]), "plain_ms": qrow["plain"],
                                         "oracle_ms": qrow["oracle"], "library_ms": qrow["library"],
                                         "bound_ms": qrow["terms"].bound_s * 1e3,
                                         "bound_by": qrow["terms"].dominant,
                                         "design": qrow["design"].removeprefix("bwd_"),
                                         "head_splits": qrow["head_splits"]})
        if name == "adamw":
            entry.update(design="multi_tensor", cell=ADAMW_CELL, leaves=row["leaves"],
                         parameters=row["parameters"], launches_per_update=row["launches_per_update"],
                         ms_default=None, pallas_counterpart=None)
        if name == "decode_attention":
            entry.update(design="split_kv", splits=row["splits_tuned"], grid=row["grid_tuned"],
                         splits_default=row["splits_default"], grid_default=row["grid_default"])
        if name == "lru_scan":
            entry.update(design="segmented", segments=row["segments"]["tuned"],
                         segments_default=row["segments"]["default"],
                         segments_serving_chunk4=row["segments"]["main_path"])
        if row["main_path"] is not None:
            entry["ms_serving_chunk4"] = row["main_path"]
        if "encoder" in row:  # seamless's encoder call, non-causal at head dim 64
            enc = row["encoder"]
            entry["encoder_shape"] = {
                "q": [eB, eS, eH, ehd], "kv": [eB, eKh, eS, ehd],
                "causal": False, "design": enc["design"], "knobs": enc["knobs"],
                "knobs_default": enc["knobs_default"], "ms": enc["tuned"], "ms_default": enc["default"],
                "plain_ms": enc["plain"], "library_ms": enc["library"],
                "bound_ms": enc["terms"].bound_s * 1e3, "bound_by": enc["terms"].dominant,
                "launches_serving_families": family_launches[name]}
        if name == "flash_attention":  # the training path's launches by model
            fam = train_report["families"]["flash_launches"]
            entry["train_by_family"] = {"qwen2_7b_2_layers": train_report["qwen2_7b_2_layers"]["cuda"]["wgmma"],
                                        **fam}
        if "rg_mqa" in row:  # recurrentgemma-2b's MQA decode, at its default knobs
            entry["ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["default"]
            entry["plain_ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["plain"]
            entry["library_ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["library"]
        kernels.append(entry)
    print(f"[11] total wall time {time.perf_counter() - t_start:.1f}s (the kernels' build included); "
          f"DBs in {out}; exec cache {exec_cache().stats()}; {smi}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
