#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: ``nvcc`` compiles every CUDA source of the port into ``build/``;
   then ``cuobjdump -sass`` must show HGMMA (wgmma) and UTMALDG (TMA tile
   loads) in the flash library and in the flash backward library (with
   UBLKCP there too: the LSE and D rows come by bulk copies), UBLKCP (bulk copies) and UCGABAR_ARV /
   UCGABAR_WAIT (the cluster barrier) in the decode library, and HMMA
   (mma.sync) in the SSD library and in the SSD backward library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at edge shapes: ``dequant_u8``
   bit-equal (also at the largest leaf of phase 5's u8 cold start),
   ``flash_attention`` and ``decode_attention`` within the tolerance of
   ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2), at head width 128
   (InternLM2; Zamba2-1.2B's shared block, phase 11: q/k/v (8,32,256,128)
   and its decode, group 1, over 288 rows), 256 (gemma3-12b, phase 7) and
   at the training forwards (InternLM2's, paper_lm's q/k/v (8,4,256,64)
   f32, phase 8, and gemma3's q (2,16,2048,256) bf16, global and window
   1024, phase 10), llava-next-mistral-7b's prefills (q (4,32,2176,128),
   (1,32,4352,128) and the engine's (8,32,576,128), over 8 KV heads, window
   4096) and decode (group 4), and
   whisper-medium's three attention shapes (hd 64, group 1: the encoder
   (8,16,1500,64) non-causal, the decoder (8,16,128,64) causal, the
   cross-attention's 128 rows over 1,500) and its two decodes (over the
   128-row cache and over the 1,500 encoder states); at the
   main-path shapes the device time of the kernel, of the plain version and
   of one library call computing the same function (profiler trace of 25
   calls, L2 flushed before each; a ``decode_attention`` call must show
   exactly one device event), and the kernel's time between two CUDA
   events (median of 25, launch overhead included), beside the least time
   the card could take (the larger of bytes over the data-sheet 3.35 TB/s
   and operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32);
4. the device feed: a CIFAR-10-shaped RawArray dataset (50,000 × 32×32×3,
   uint8 codes on disk) for one full epoch at batch 512, then 8 batches of
   an ImageNet-shaped one (2,048 × 224×224×3, batch 256), every batch held
   against the host decode of the same batch;
5. serving: InternLM2-1.8B at its full widths and depth (24 layers, bf16,
   random weights from seed 0 on the card, the attention projections scaled
   to their true fan-in: see ``_temper_attention``) saved as a RawArray checkpoint,
   raw and ``quantize="u8"``; both restored by the cold start (raw leaves
   bit-equal to the saved ones, u8 leaves bit-equal to the plain decode of
   their codes, one ``dequant_u8`` launch per float leaf); then
   ``ServeEngine(checkpoint=raw)`` answers 8 prompts of 512 tokens with 64
   new tokens each (24 ``flash_attention`` and 24 × 64 ``decode_attention``
   launches, all 24 flash launches on the tensor-core kernel), warm again,
   then one request with a 4,096-token prompt (``long_prefill_s``, 24
   tensor-core flash launches), and the 8 requests again with the two
   attention ops swapped for their plain versions: first-step logits within
   a bf16 tolerance, greedy-token agreement reported. The u8 checkpoint is of an
   f32 copy of the weights (a training checkpoint's dtype), since bf16
   leaves are stored verbatim under ``quantize="u8"``;
3c. (run with phase 3) ``ssd_scan`` against its plain version on the card:
   the serving shape, Zamba2-1.2B's prefill (x (8,64,256,64), N 64), a
   long prompt, the JAX sweep's f32 shapes, a chunk of 100, a single chunk
   and a slow decay that keeps the state alive across every chunk; y and
   the final state within their tolerances; then the scan's backward
   (``csrc/ssd_scan_bwd.cu``: bf16 on the tensor cores, ``mma.sync``; f32 on
   the SIMT pipes) against its plain version (``ref.ssd_scan_bwd_ref``) at
   phases 22-23's training shapes (x (4,48,2048,64), B/C (4,2048,128) bf16;
   x (4,64,2048,64), N 64) and edges (Q 100 and 40, slow decay, P 32 at N 16
   and 32 with 9 and 12 heads, f32 at N 64 and 128, the reduced widths): dx,
   d(dtA), dB and dC within f32 1e-4 / bf16 2e-2 of each one's largest entry,
   two calls bit-equal, every bf16 call on the tensor-core kernels; at the
   training shapes the device time, the plain version's and the bound (no
   library call computes the scan);
6. serving: Mamba2-780M at its full widths and depth (48 layers, bf16,
   random weights from seed 0 on the card) saved as a raw RawArray
   checkpoint and restored through ``ServeEngine(checkpoint=raw)`` (leaves
   bit-equal); 8 prompts of 512 tokens with 64 new tokens each (48
   ``ssd_scan`` launches, all 48 on the tensor-core kernels, no attention
   launch), warm again, and again with
   the scan swapped for its plain version: first-step logits within a bf16
   tolerance, greedy-token agreement reported;
3d. (run with phase 3) the backward of ``flash_attention``
   (``csrc/flash_attention_bwd.cu``: f32 on the SIMT pipes, bf16 on the
   tensor cores by ``wgmma`` fed by a TMA ring) against its plain version
   on the card: paper_lm's training shape (q/k/v (8,4,256,64) f32, causal),
   InternLM2's (q (4,16,2048,128), k/v (4,8,2048,128) bf16, causal),
   gemma3-12b's (q (2,16,2048,256), k/v (2,8,2048,256) bf16, causal, its
   local layers' window 1024 and its global layers), whisper-medium's (hd
   64, group 1: the encoder (8,16,1500,64) non-causal, the cross-attention's
   448 rows over 1,500 keys, the decoder (8,16,448,64) causal), llava's
   (q (2,32,4096,128), k/v (2,8,4096,128), window 4096), kimi-k2-1t's (q
   (2,64,4096,112), k/v (2,8,4096,112)) and deepseek-v3's expanded MLA (q/k
   (2,128,4096,192), v (2,128,4096,128), group 1), whose plain versions run a
   group of heads a call where one call's (Sq, Sk) scores would pass 4.3 GB
   (the row says how many), and edges (at (112, 112) and (192, 128): ragged,
   Sq != Sk both ways, non-causal; a ragged
   S, window 1024, hd 32, hd 256, 64-row tiles, groups of 1, 2, 4 and 8;
   Sq != Sk causal both ways, one row over 1,500 keys, with a window, in
   f32; bf16 non-causal at hd 32, 128 and 256; llava's window where it
   bites, 4,352 positions); dq, dk, dv within f32 1e-4 / bf16 2e-2 of each
   one's largest entry, two calls bit-equal, and where Sk > Sq under the
   causal mask the keys no row sees get exactly zero; the training forward's
   output within the forward's tolerance of the plain one and its f32 copy
   rounding to it exactly; at the training shapes the device time, the plain
   version's, and the backward of ``scaled_dot_product_attention`` (K/V
   repeated over the group, a boolean mask for the window; timed only),
   beside the bound (bytes over 3.35 TB/s, or 2.5 × the masked forward's
   operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32), and the training
   forward's device time (``return_lse``: the LSE, the f32 output and the
   product of P − bf16(P)) beside the serving forward's on the same inputs;
7. serving: gemma3-12b at its full widths (d_model 3840, 16 heads / 8 KV of
   head width 256, GeGLU 15360, vocab 262,144, QK-norm, sandwich norms, 5
   local layers of window 1024 to 1 global), its depth cut from 48 to 12
   layers (two periods of the pattern), bf16, random weights from seed 0 on
   the card with the attention projections tempered as InternLM2's, saved as
   a raw RawArray checkpoint and restored through
   ``ServeEngine(checkpoint=raw)`` (leaves bit-equal); 4 prompts of 2,048
   tokens (numpy seed 2, longer than the window) with 32 new tokens each (12
   ``flash_attention`` launches, all on the tensor-core kernel, and 12 × 32
   ``decode_attention`` launches, one device event per layer in a traced
   step), warm again, and again with plain attention: first-step logits
   within a bf16 tolerance, greedy-token agreement reported;
8. training: paper_lm at its published size (4 layers, d_model 256, vocab
   4,096, f32) through the port's CLI (``repro_torch.launch.train.run``),
   with ``--device-feed --batch 8`` on a RawArray token dataset (seq 256,
   seed 0): 60 steps straight, then 40 steps and a resume to 60 from the
   step-40 checkpoint (it must print ``[train] resumed from step 40``); the
   loss falls, the two runs' parameters agree (rtol 1e-5, atol 1e-6;
   bit-equality reported), each run launches the flash forward and
   backward kernels once a layer a step; then ``ServeEngine`` restores the
   trained checkpoint and answers 2 prompts of 64 tokens with 16 greedy
   tokens, equal to a run with plain attention; one more step of a fresh
   model under the profiler (forward and backward, then the optimizer):
   device time by kind and the idle share;
9. training: InternLM2-1.8B at its full widths and depth (24 layers, bf16,
   remat), random weights from seed 0 with the attention tempered as in
   phase 5, a RawArray token dataset of 64 × 2,048 tokens at vocab 92,544
   (numpy seed 3) fed by ``DeviceLoader``, batch 4 × 2,048: the first step's
   loss and global gradient norm against a first step with plain attention
   (within 1% and 2%), and each layer's wq/wk/wv/wo gradient against plain
   attention's (relative error within ``ATTN_GRAD_TOL``; two planted
   backward faults, dk zeroed and dq 10% too large, must exceed it), then ``train()`` for 6 steps with f32 AdamW moments,
   a checkpoint at step 6 (params and optimizer state, 18.9 GB) restored
   by ``restore_pipelined`` bit-equal, launch counts 24 × 6 × 2 forward
   (remat runs each layer's forward twice) and 24 × 6 backward; then one
   more step under the profiler, as in phase 8;
10. training: gemma3-12b at its full widths (phase 7's model, head width
   256, 5 local layers of window 1024 to 1 global, remat) and 12 of 48
   layers, random weights from seed 0 tempered as in phase 5, a RawArray
   token dataset of 16 × 2,048 tokens at vocab 262,144 (numpy seed 4),
   batch 2 × 2,048 (past the window, so the local and the global backward
   both run): the first step's gates of phase 9, then 4 steps of the train
   loop's step (``train.loop.make_step``, on ``DeviceLoader`` batches; no
   checkpoint: ``train()`` would save 37 GB at its end, and phases 8 and 9
   hold that path) with the loss falling, launch counts 12 × 4 × 2 forward
   and 12 × 4 backward, peak device memory; then one more step under the
   profiler, as in phase 8. In a profiled step the attention kernels are
   found by the ``__global__`` functions of their sources;
11. serving: Zamba2-1.2B at its full size (38 Mamba2 layers, d_model 2048,
   one shared attention+MLP block, 32 heads of 128 over ``concat([x, x0])``,
   invoked 6 times; bf16, 1.2 B parameters, nothing cut), random weights from
   seed 0 with the shared attention tempered as in phase 5, saved as a raw
   RawArray checkpoint and restored through ``ServeEngine(checkpoint=raw)``
   (leaves bit-equal); 8 prompts of 256 tokens (numpy seed 3) with 32 new
   tokens each, served through the engine's prompt replay (6 × 287
   ``decode_attention`` launches and nothing else), warm again (ms per
   replayed token), and again with attention and scan plain: first-step
   logits within a bf16 tolerance, greedy-token agreement reported; then
   ``model.prefill`` (6 flash and 38 ``ssd_scan`` launches, all on the
   tensor cores) within the same tolerance of its plain version, and an f32
   copy's prefill against its replay (rtol 2e-3, atol 2e-4 of the logits'
   scale, ``tests/test_models.py:63-78``);
12. the remote data plane: phase 4's CIFAR-10-shaped dataset and phase 5's
   InternLM2-1.8B checkpoints (kept for this phase) served by the port's
   byte-range server in a subprocess (``python -m
   repro_torch.remote.server``, uploads with a token): ``restore_pipelined``
   from its URL, raw (3,778,220,032 bytes) and u8 (12 ``dequant_u8``
   launches), each bit-equal to the local restore run beside it; the raw
   restore again through ``fleet.serve(origin_url=..., replicas=3)``, cold
   and then warm edges (bit-equal, the warm pass with no origin fetch);
   ``ServeEngine(checkpoint=url)`` answering phase 5's 8 prompts with 64
   tokens (24 flash and 24 × 64 decode launches), its greedy tokens equal
   to phase 5's engine's; the device feed over the URL for one epoch (every
   batch bit-equal to the host decode of the local files); a save of the
   restored weights to the URL, restored from it bit-equal. Loopback HTTP
   on one host: its rates are bound by the host, not by a network;
13. the data mesh (DESIGN.md §15) over phase 4's dataset and phase 5's
   checkpoints: (a) one CIFAR epoch through ``DataLoader(mesh=DataMesh("h0",
   ["h0"]))`` and the global ``DeviceLoader`` over a one-rank NCCL group,
   every batch a ``DTensor`` bit-equal to the host decode, one
   ``dequant_u8`` launch a batch, batches/s beside phase 4's; (b) four
   simulated hosts ``h0..h3`` in this process, each a mesh loader feeding
   ``DeviceLoader(global_arrays=False)`` on the card for one epoch (the
   first whose ring deal gives every host a shard; a zero-step epoch before
   it must raise), every row once, every batch the host decode of its
   planned rows, steps and dropped tails equal across hosts; (c) the raw
   and u8 InternLM2 checkpoints restored with the layer axis of every
   stacked leaf sharded over ``"data"`` (u8 decoded on the host, no
   launch), bit-equal to the unsharded restore beside it (u8 by the
   kernel); (d) paper_lm through ``launch.train`` with ``--device-feed`` on a
   one-host mesh by flags, then by ``RA_MESH_HOSTS``/``RA_MESH_HOST``:
   equal losses, the flash forward and backward launches of each;
14. serving: llava-next-mistral-7b at its full size (the Mistral-7B
   backbone, 32 layers, d_model 4,096, 32 heads over 8 KV heads of 128, the
   window 4,096 on every layer, and ``mm_proj`` for the stub vision front
   end's 1,152 patches; bf16, 7.26 B parameters, nothing cut), random
   weights from seed 0 tempered as in phase 5, saved as a raw RawArray
   checkpoint (14.5 GB, deleted after the restore) and restored through
   ``ServeEngine(checkpoint=raw)`` (leaves bit-equal); (a) ``model.prefill``
   with patches, 4 × (1,152 + 1,024) and 1 × (1,152 + 3,200) positions (past
   the window), 32 tensor-core flash launches each, last-position logits
   within a bf16 tolerance of plain attention's; (b) the engine, text-only
   as the JAX engine serves this family: 8 prompts of 512 with 64 new tokens
   (32 flash and 32 × 64 decode launches), warm again, first-step logits
   against plain attention;
15. serving: whisper-medium at its full size (24 encoder and 24 decoder
   layers, d_model 1,024, 16 heads of 64, 1,500 encoder positions, vocab
   51,865; bf16, nothing cut), random weights from seed 0 with all three
   attention kinds tempered, saved as a raw RawArray checkpoint and restored
   by ``restore_pipelined`` onto a meta-device model (leaves bit-equal); the
   encoder over 8 × 1,500 random frames (the stub audio front end; 24
   non-causal flash launches), its output within a bf16 tolerance of plain
   attention's; then 8 requests of a 16-token prompt and 112 new tokens by
   the JAX engine's algorithm on the model's own entry points (which the
   engine cannot serve: prefill right-padded to 128 with the frames, rewind,
   greedy ``decode_step``s): 24 encoder, 24 decoder and 24 cross flash
   launches, 24 × 112 self- and 24 × 112 cross-attention decode launches,
   first-step logits against plain attention, 8 profiled decode steps
   (device idle share);
16. training: whisper-medium at full size (nothing cut; remat), random
   weights from seed 0 with all three attention kinds tempered, a RawArray
   dataset of 64 rows of 1,500 frames (stored as u8 codes, the stub audio
   front end's output) and 448 tokens (the reference's ``ENCDEC_TGT``),
   batch 8: the first step's loss and gradient norm against plain
   attention's (phase 9's 1% and 2%), every layer's encoder, self- and
   cross-attention gradients within ``ATTN_GRAD_TOL`` of the same forward
   with the plain backward (read against plain attention beside the control
   plain f32 against plain f64, which reaches the tolerance's order here),
   the planted faults caught; then ``train()`` on ``DeviceLoader``
   batches (the frames decoded by ``dequant_u8`` on the card) for 6 steps,
   the loss falling, with a checkpoint at step 4, and a second ``train()``
   that resumes there for the last 2 steps, its losses within the resume gate (rtol 1e-5, atol
   1e-6) of the first's; launch counts by attention kind (24 × 6 × 2
   forward and 24 × 6 backward each for the encoder, the decoder and the
   cross-attention, Sq 448 over Sk 1,500), a dequant launch a batch; step
   s, decoder tokens/s and frames/s, peak memory, ``ckpt_save_s``, the
   resume's restore s, a profiled step;
17. training: llava-next-mistral-7b at full widths and 22 of 32 layers
   (``LLAVA_TRAIN_LAYERS``, the deepest under ~72 GB; remat), random
   weights from seed 0 tempered, a RawArray dataset of 16 rows of 1,152
   patch embeddings (stored as u8) and 2,944 tokens, batch 2 × 4,096
   positions (the reference's train row): the first step's loss and
   gradient norm against plain attention's (phase 9's 1% and 2%), each
   layer's attention gradients within ``ATTN_GRAD_TOL`` of the same forward
   with the plain backward (against plain attention they are read, beside
   the control plain f32 against plain f64, which alone passes the
   tolerance here), the planted faults caught; then 4 steps of
   ``make_step`` on ``DeviceLoader`` batches with the loss falling, launch
   counts 22 × 4 × 2 forward and 22 × 4 backward, a dequant launch a batch,
   peak memory, a profiled step. The text tokens of phases 16 and 17 come
   from ``data.synth.markov_tokens``, phase 9's token generator (Zipf
   starts, fixed successors);
18. serving: kimi-k2-1t-a32b at its full widths (d_model 7,168, 64 heads
   over 8 KV heads of head width 112, 384 routed experts of 2,048 and one
   shared, top-8 by a sigmoid router, 8 dispatch chunks, vocab 163,840;
   bf16) and 2 of 61 layers (the dense first layer and one MoE layer: 19.9 B
   parameters, 39.9 GB), random weights from seed 0 built on the card with
   the attention tempered as in phase 5; 8 prompts of 512 tokens with 64 new
   tokens through ``ServeEngine`` (2 flash launches on the tensor cores at
   (112, 112) and 2 × 64 decode launches), warm again; the first prefill's
   and the first step's logits within ``LOGITS_TOL`` of plain attention's
   (held under the plain run's routes where a routing near-tie breaks the
   other way, and then said so), the share of (token, k) routes that differ
   between the two runs, greedy-token agreement, prefill_s, decode tokens/s
   and peak device memory;
19. serving: deepseek-v3-671b at its full widths (MLA with q_lora 1,536,
   kv_lora 512, rope 64, 128 heads; 256 routed experts and one shared) and 4
   of 61 layers (the 3 dense prefix layers and one MoE layer, plus the MTP
   leaves, carried and not served: 15.8 B parameters, 31.6 GB), tempered
   (MLA's ``wq_b``, ``wkv_b`` and ``wo``), saved as a raw RawArray checkpoint
   (deleted after the restore) and cold-started onto a meta-device model by
   ``restore_pipelined`` (every leaf bit-equal; cold-start s and GB/s), then
   served as phase 18 (4 flash launches at (192, 128) and 4 × 64 absorbed
   decode launches at (576, 512), V read from the latent rows).
   Phase 3b holds both kernels at these widths (kimi's prefill q
   (8,64,576,112) and decode, group 8; the MLA prefill q/k (8,128,576,192), v
   (8,128,576,128), and the MLA decode, 128 heads over (8,1,576,576) rows,
   scale 192^-1/2) against their plain versions, with edges (ragged tiles,
   Sk > Sq, windows, pos 0 and inside the first tile, f32), and the flash
   kernel at phases 20-21's training shapes (q (2,64,4096,112); q/k
   (2,128,4096,192), v 128; the plain version by head groups);
20. training: kimi-k2-1t-a32b at its full widths and phase 18's 2 layers,
   with 64 of its 384 routed experts (everything else, the experts' shapes,
   top-8, the router, the shared expert, capacity factor 1.25 and 8
   dispatch chunks, as published: one MoE layer's 384 experts alone would
   need 102 GB of training states), bf16, remat, random weights from seed 0
   tempered, a RawArray token dataset of 16 × 4,096 tokens (the reference's
   train_4k row) at batch 2 through ``DeviceLoader``: the first step's loss
   and gradient norm against plain attention's (1% and 2%; the plain
   attention, its f64 control and the plain backward a group of heads a
   call), every layer's wq/wk/wv/wo gradient within ``ATTN_GRAD_TOL`` of the
   same forward with the plain backward, the planted faults caught; two
   first steps with every gradient leaf bit-equal; then 4 steps of
   ``make_step`` with AdamW at the config's int8 moments (no checkpoint),
   the losses finite and lower after the first update (the one exact f32
   AdamW step of the reference's int8 mode: later ones move an entry whose
   gradient vanished by ~lr·m/eps, ROADMAP.md §3 fault 10; whether the loss
   falls over the 4 steps, the grad norms, the moments' stale entries and the
   largest parameter entries after each step are printed), launch counts
   2 × 4 × 2 forward (all on the
   tensor cores) and 2 × 4 backward, by width pair; step s, tokens/s, peak
   memory beside its prediction, the share of routes dropped, a profiled
   step, the card's name and power limit;
21. training: deepseek-v3-671b as phase 20, at phase 19's 4 layers (3 dense,
   1 MoE) with 64 of 256 routed experts, MLA expanded at (192, 128), and the
   MTP loss (its one dense layer, not under remat): its MLA's
   wq_a/wq_b/wkv_a/wkv_b/wo gradients gated, the MTP layer's too; launch
   counts (4 × 2 + 1) × 4 forward and 5 × 4 backward;
22. training: Mamba2-780M at full size (48 layers, d_model 1,536, 48 SSD
   heads of 64, N 128, chunk 128, bf16, remat; nothing cut but the steps),
   random weights from seed 0, a RawArray token dataset of 16 × 2,048 tokens
   at vocab 50,280 through ``DeviceLoader``, batch 4 × 2,048, the config's
   f32 AdamW moments: the first step against the same forward kernels with
   the scan's plain backward (loss within 1%, gradient norm within 2%, each
   layer's w_x/w_B/w_C/w_dt/A_log/dt_bias/D gradient within
   ``SSM_GRAD_TOL``; two planted faults of the scan's backward, dB from one
   head and d(dtA) 10% too large, must break that gate), two first steps
   bit-equal leaf by leaf, then ``train()`` for 4 steps with a checkpoint at
   step 2 and a second ``train()`` resumed there (its losses within rtol
   1e-5, atol 1e-6 of the first's); launch counts 48 × 4 × 2 forward and
   48 × 4 backward, all on the tensor cores (the resumed run's 48 × 2
   backward too); step s (the median of steps 2 and
   4: step 1 warms, step 3 waits for the checkpoint's snapshot), tokens/s,
   peak memory, a
   profiled step (device ms by kind, scan forward and backward by their
   sources' kernel names);
23. training: Zamba2-1.2B at full size as phase 22 (38 layers at N 64 and
   the shared block 6 times, its attention tempered as in phase 5), the
   shared block's flash forward and backward at (128, 128), group 1, 6 × 4
   each beside the scan's 38 × 4 × 2 and 38 × 4.

The last three lines are the card's name and power limit, one JSON object
listing each kernel, and the result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of each gradient's largest |entry|
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:19
# ssd_scan: f32 as tests/test_kernels.py:79 (rtol 1e-3, atol 1e-4); bf16 2e-2 of the
# output's scale (kernel and plain version both compute in f32 and differ in the
# order of their sums; y is rounded once to bf16, 2**-8 relative); the f32 final
# state 1e-3 of its scale (sums over up to 4,096 steps in another order)
SSD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (0.0, 2e-2)}
SSD_STATE_TOL = 1e-3
LOGITS_TOL = 5e-2  # of max |plain logits|: bf16 activations through 24 layers
REPS = 25
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------- phase 1
def phase_environment(torch) -> str:
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch sees {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    return card


# --------------------------------------------------------------- phase 2
def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    for source, text in logs.items():
        log(f"[build] nvcc {source}:\n{text.strip()}")
    log(f"[build] {len(logs)} source(s) compiled, {len(_build.SOURCES) - len(logs)} "
        f"already built, {seconds:.3f} s")
    return seconds


def phase_sass() -> dict:
    """Count, in each built library, the instructions its design rests on:
    the bf16 flash kernel runs on the tensor cores (HGMMA, wgmma) fed by TMA
    (UTMALDG); so does the bf16 flash backward, whose dK/dV kernel also
    brings each tile's LSE and D rows by bulk copies (UBLKCP); the decode kernel streams K/V by bulk
    copies (UBLKCP) and folds its splits across a cluster (UCGABAR_ARV /
    UCGABAR_WAIT, the cluster barrier); the bf16 SSD scan and its backward
    run their products on the tensor cores (HMMA, mma.sync). Any count of 0
    fails."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    wanted = {
        "flash_attention.cu": ("HGMMA", "UTMALDG"),
        "flash_attention_bwd.cu": ("HGMMA", "UTMALDG", "UBLKCP"),
        "decode_attention.cu": ("UBLKCP", "UCGABAR_ARV", "UCGABAR_WAIT"),
        "ssd_scan.cu": ("HMMA",),
        "ssd_scan_bwd.cu": ("HMMA",),
    }
    counts = {}
    for source, ops in wanted.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(source))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[source] = {op: sass.count(op) for op in ops}
    log(f"[sass] {json.dumps(counts)}")
    missing = {src: c for src, c in counts.items() if not all(c.values())}
    if missing:
        raise SystemExit(f"chip_smoke: instructions missing from the SASS: {missing}")
    return counts


# --------------------------------------------------------------- phase 3
def _event_ms(torch, fn, flush) -> float:
    """Median over REPS of one call between two CUDA events, L2 flushed
    before each. Includes any gap while the host issues the call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()  # cold L2; also keeps the card busy while the call is issued
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, flush, attempts: int = 3, events: int | None = None) -> float:
    """Device time of one call: the summed durations of the kernels it ran,
    from a profiler trace of REPS calls (L2 flushed before each; the flush's
    own fill kernels are left out), divided by REPS. Host launch overhead
    and gaps between a call's kernels are not in it. A trace whose event
    count is not a multiple of REPS (a library call, cuDNN's masked SDPA,
    has shown one now and then) is taken again, up to ``attempts`` times;
    if the last is still short by at most 2 events of each kernel, the call's
    time is each kernel's mean duration times its count a call.
    With ``events``, a trace must show exactly that many device events per
    call; one that does not (the profiler has dropped a few events now and
    then) is taken again, and if no trace of ``attempts`` does, the run
    fails."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        names, name_us = Counter(), Counter()
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "FillFunctor" in evt.name or evt.name == "Activity Buffer Request":
                continue
            total_us += evt.time_range.elapsed_us()
            names[evt.name[:120]] += 1
            name_us[evt.name[:120]] += evt.time_range.elapsed_us()
        count = sum(names.values())
        if events is not None and count == events * REPS:
            return total_us / REPS / 1e3
        if events is None and count and count % REPS == 0:
            return total_us / REPS / 1e3
        log(f"[kernels] the profiler saw {count} device events in {REPS} calls: "
            f"{dict(names)}")
    if events is not None:
        raise SystemExit(f"chip_smoke: {attempts} profiler traces of {REPS} calls each, "
                         f"none with {events} device events per call")
    # every trace missed a few events of a call of many kernels (a plain version
    # has missed one in 325 on three traces running): each kernel's mean over the
    # events seen, times its count a call, where that count is clear
    per_call = {n: round(c / REPS) for n, c in names.items()}
    if names and all(per_call[n] >= 1 and abs(c - per_call[n] * REPS) <= 2
                     for n, c in names.items()):
        ms = sum(name_us[n] / names[n] * per_call[n] for n in names) / 1e3
        log(f"[kernels] {ms} ms a call from each kernel's mean, the last trace short")
        return ms
    raise SystemExit(f"chip_smoke: {attempts} profiler traces of {REPS} calls each "
                     f"saw a number of device events that is not a multiple of {REPS}")


def _largest_leaf(torch) -> tuple:
    """Shape of the largest float leaf that phase 5's u8 cold start decodes
    (InternLM2-1.8B; the checkpoint is of an f32 copy, so it decodes to f32)."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    leaves = flatten(build_model(get_config("internlm2_1_8b"), device="meta").param_tree(),
                     "param").values()
    return tuple(max(leaves, key=lambda t: t.numel()).shape)


def phase_kernels(torch) -> list:
    from repro_torch.kernels import dequant_u8, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MiB > 50 MB L2

    def inputs(shape, offset=0):
        C = shape[-1]
        n = 1
        for d in shape:
            n *= d
        buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device=dev, generator=gen)
        x = buf[offset:].view(shape)
        scale = torch.rand(C, device=dev, generator=gen) * 0.02 + 1e-3
        bias = torch.randn(C, device=dev, generator=gen)
        return x, scale, bias

    # (label, shape, out dtype, timed, pointer offset); timed = a main-path shape
    cases = [
        ("cifar_batch", (512, 32, 32, 3), torch.float32, True, 0),
        ("imagenet_batch", (256, 224, 224, 3), torch.float32, True, 0),
        ("imagenet_batch", (256, 224, 224, 3), torch.bfloat16, True, 0),
        ("checkpoint_leaf", (4096, 4096), torch.bfloat16, True, 0),
        ("u8_cold_start_largest_leaf", _largest_leaf(torch), torch.float32, True, 0),
        # the training feeds' batches (phases 16 and 17): whisper-medium's frames and
        # llava-next-mistral-7b's patch embeddings, stored as u8 codes
        ("whisper_frames_batch", (8, 1500, 1024), torch.float32, True, 0),
        ("llava_patch_batch", (2, 1152, 4096), torch.float32, True, 0),
        ("edge", (1, 1), torch.float32, False, 0),
        ("edge", (1000, 130), torch.float32, False, 0),
        ("edge", (1000, 130), torch.bfloat16, False, 0),
        ("edge", (1000, 130), torch.float16, False, 0),
        ("edge", (1000, 130), torch.float64, False, 0),
        ("edge_misaligned", (1000, 130), torch.float32, False, 1),
        ("edge_misaligned", (999, 3), torch.bfloat16, False, 3),
    ]
    rows = []
    for label, shape, out_dtype, timed, offset in cases:
        x, scale, bias = inputs(shape, offset)
        out = dequant_u8.dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)
        torch.cuda.synchronize()
        plain = ref.dequant_u8_ref(x, scale, bias, out_dtype)
        exact = bool(torch.equal(out, plain))
        err = float((out.double() - plain.double()).abs().max()) if out.numel() else 0.0
        E, blocks, stride = dequant_u8.launch_plan(x, out)
        row = {
            "case": label, "shape": list(shape), "out_dtype": str(out_dtype).split(".")[-1],
            "data_ptr_mod_16": int(x.data_ptr() % 16), "exact": exact, "max_abs_err": err,
            "codes_per_group": E, "blocks": blocks, "stride_groups": stride,
        }
        if timed:
            n = x.numel()
            out_bytes = torch.empty(0, dtype=out_dtype).element_size()
            lib_scale, lib_bias = scale.to(out_dtype), bias.to(out_dtype)
            kernel = lambda: dequant_u8.dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)
            plain_fn = lambda: ref.dequant_u8_ref(x, scale, bias, out_dtype)
            library = lambda: torch.addcmul(lib_bias, x, lib_scale)
            row.update(
                ms=_device_ms(torch, kernel, flush),
                plain_ms=_device_ms(torch, plain_fn, flush),
                library_ms=_device_ms(torch, library, flush),
                event_ms=_event_ms(torch, kernel, flush),
                bound_ms=(n + n * out_bytes) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes",
            )
        log(f"[kernels] dequant_u8 {json.dumps(row)}")
        rows.append(row)
        if not exact:
            raise SystemExit(f"chip_smoke: dequant_u8 differs from its plain version: {row}")
        del x, out, plain
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3b
def _live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask keeps: the work this input needs."""
    import numpy as np

    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return int(ok.sum())


def _bound(nbytes: int, flops: int, peak: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _timings(torch, kernel, plain, library, flush, nbytes, flops, events=None,
             peak: float = BF16_FLOPS) -> dict:
    """Device ms of the kernel (``events``: the device events each call must
    show), its plain version and the library call (None where no single
    library call computes the function), event ms, bound (operations over
    ``peak``)."""
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    return {
        "ms": _device_ms(torch, kernel, flush, events=events),
        "plain_ms": _device_ms(torch, plain, flush),
        "library_ms": _device_ms(torch, library, flush) if library is not None else None,
        "event_ms": _event_ms(torch, kernel, flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }


def _check_close(torch, name, row, out, plain):
    tol = ATTN_TOL[row["dtype"]]
    row["max_abs_err"] = float((out.float() - plain.float()).abs().max()) if out.numel() else 0.0
    row["tolerance"] = tol
    ok = bool(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol))
    log(f"[kernels] {name} {json.dumps(row)}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} differs from its plain version: {row}")


def phase_attention(torch) -> tuple:
    """Both attention kernels against their plain versions on the card."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dtype])

    # (label, B, H, KV, Sq, Sk, hd, dtype, causal, window, timed)
    flash_cases = [
        ("prefill", 8, 16, 8, 576, 576, 128, "bfloat16", True, 0, True),
        ("long_prefill", 1, 16, 8, 4096, 4096, 128, "bfloat16", True, 0, True),
        # InternLM2's training forward (phase 9): 4 sequences of 2,048 tokens
        ("internlm2_train", 4, 16, 8, 2048, 2048, 128, "bfloat16", True, 0, True),
        # paper_lm's training forward (phase 8): 8 sequences of 256 tokens, f32
        ("paper_lm_train", 8, 4, 4, 256, 256, 64, "float32", True, 0, True),
        ("edge_one_row", 1, 16, 8, 1, 1, 128, "bfloat16", True, 0, False),
        ("edge_tail_tile_bf16", 2, 16, 8, 130, 130, 128, "bfloat16", True, 0, False),
        ("edge_sk_gt_sq", 2, 16, 8, 96, 160, 128, "bfloat16", True, 0, False),
        ("edge_tail_tile", 2, 4, 2, 130, 130, 64, "float32", True, 0, False),
        ("edge_window_64", 2, 16, 8, 576, 576, 128, "bfloat16", True, 64, False),
        ("edge_hd64", 2, 8, 8, 200, 200, 64, "float32", True, 0, False),
        ("edge_hd32", 2, 4, 2, 100, 100, 32, "bfloat16", True, 0, False),
        ("edge_g1", 2, 4, 4, 256, 256, 64, "bfloat16", False, 0, False),
        ("edge_f32", 2, 16, 8, 576, 576, 128, "float32", True, 0, False),
        # gemma3-12b (phase 7): its prefill, 4 prompts padded to 2,048 + 32 rows,
        # on a global layer and on a local one (window 1024)
        ("gemma3_prefill", 4, 16, 8, 2080, 2080, 256, "bfloat16", True, 0, True),
        ("gemma3_prefill_local", 4, 16, 8, 2080, 2080, 256, "bfloat16", True, 1024, True),
        # gemma3-12b's training forward (phase 10): 2 sequences of 2,048 tokens, on
        # a global layer and on a local one
        ("gemma3_train", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 0, True),
        ("gemma3_train_local", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 1024, True),
        ("edge_hd256_f32", 2, 4, 2, 300, 300, 256, "float32", True, 64, False),
        ("edge_hd256_tail_tile", 2, 16, 8, 130, 130, 256, "bfloat16", True, 0, False),
        ("edge_hd256_sk_gt_sq", 2, 16, 8, 96, 160, 256, "bfloat16", True, 0, False),
        ("edge_hd256_g1", 2, 4, 4, 256, 256, 256, "bfloat16", False, 0, False),
        # Zamba2-1.2B's model.prefill (phase 11): the shared block's MHA over
        # concat([x, x0]), 32 heads of 128, 8 prompts of 256 tokens
        ("zamba2_prefill", 8, 32, 32, 256, 256, 128, "bfloat16", True, 0, True),
        # llava-next-mistral-7b (phase 14): 32 heads over 8 KV heads of 128, the
        # window 4096 on every layer; model.prefill of 4 × (1,152 patches + 1,024
        # tokens), and of 1 × (1,152 + 3,200), past the window; the engine's
        # text-only prefill, 8 prompts padded to 512 + 64 rows
        ("llava_prefill", 4, 32, 8, 2176, 2176, 128, "bfloat16", True, 4096, True),
        ("llava_long_prefill", 1, 32, 8, 4352, 4352, 128, "bfloat16", True, 4096, True),
        ("llava_engine_prefill", 8, 32, 8, 576, 576, 128, "bfloat16", True, 4096, True),
        # whisper-medium (phase 15): 16 heads of 64 (group 1); the encoder over
        # 1,500 frames, the decoder's self-attention over its 128-row capacity,
        # and its cross-attention, 128 rows over the 1,500 encoder states
        ("whisper_encoder", 8, 16, 16, 1500, 1500, 64, "bfloat16", False, 0, True),
        ("whisper_decoder", 8, 16, 16, 128, 128, 64, "bfloat16", True, 0, True),
        ("whisper_cross", 8, 16, 16, 128, 1500, 64, "bfloat16", False, 0, True),
        # kimi-k2-1t (phase 18): 64 heads over 8 KV heads of 112, the engine's
        # prefill of 8 prompts padded to 512 + 64 rows; deepseek-v3-671b's MLA
        # prefill (phase 19), expanded: 128 heads, q·k 128 + 64 wide, v 128
        ("kimi_prefill", 8, 64, 8, 576, 576, 112, "bfloat16", True, 0, True),
        ("deepseek_mla_prefill", 8, 128, 128, 576, 576, 192, "bfloat16", True, 0, True, 128),
        # their training forwards (phases 20-21): 2 sequences of 4,096 tokens
        ("kimi_train", 2, 64, 8, 4096, 4096, 112, "bfloat16", True, 0, True),
        ("deepseek_mla_train", 2, 128, 128, 4096, 4096, 192, "bfloat16", True, 0, True, 128),
        ("edge_hd112_tail_tile", 2, 16, 2, 130, 130, 112, "bfloat16", True, 0, False),
        ("edge_hd112_sk_gt_sq", 2, 8, 1, 96, 160, 112, "bfloat16", True, 0, False),
        ("edge_hd112_window", 1, 8, 8, 300, 300, 112, "bfloat16", True, 64, False),
        ("edge_hd112_f32", 2, 8, 1, 200, 200, 112, "float32", True, 0, False),
        ("edge_mla_tail_tile", 2, 16, 16, 130, 130, 192, "bfloat16", True, 0, False, 128),
        ("edge_mla_sk_gt_sq", 2, 8, 8, 96, 161, 192, "bfloat16", True, 0, False, 128),
        ("edge_mla_non_causal", 1, 4, 4, 200, 200, 192, "bfloat16", False, 0, False, 128),
        ("edge_mla_f32", 2, 4, 4, 130, 130, 192, "float32", True, 0, False, 128),
    ]
    flash_rows = []
    for label, B, H, KV, Sq, Sk, hd, dt, causal, window, timed, *dv in flash_cases:
        dv = dv[0] if dv else hd  # v's width, where it is not q·k's
        q, k, v = randn((B, H, Sq, hd), dt), randn((B, KV, Sk, hd), dt), randn((B, KV, Sk, dv), dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        heads = _plain_heads(B, H, KV, Sq, Sk)  # by head groups past PLAIN_BYTES of scores

        def plain_fn():
            def fn(q, k, v):
                return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

            return fn(q, k, v) if heads is None else _by_heads(torch, fn, heads, q, k, v)

        plain = plain_fn()
        row = {"case": label, "shape": {"q": [B, H, Sq, hd], "kv": [B, KV, Sk, hd]},
               "dtype": dt, "causal": causal, "window": window}
        if dv != hd:
            row["shape"]["v"] = [B, KV, Sk, dv]
        if heads is not None:
            row["plain_heads_per_call"] = heads
        if timed:
            esize = q.element_size()
            nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * esize
            flops = 2 * (hd + dv) * B * H * _live_pairs(Sq, Sk, causal, window)
            if window:  # the same function in one library call: a boolean mask
                qp, kp = torch.arange(Sq, device=dev)[:, None], torch.arange(Sk, device=dev)
                keep = (kp <= qp) & (kp > qp - window)
                library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                                 enable_gqa=True)
            else:
                library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                 enable_gqa=True)
            row.update(_timings(
                torch,
                lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                plain_fn, library, flush, nbytes, flops,
                peak=BF16_FLOPS if dt == "bfloat16" else F32_FLOPS,
            ))
            row["peak_flops"] = BF16_FLOPS if dt == "bfloat16" else F32_FLOPS
        _check_close(torch, "flash_attention", row, out, plain)
        flash_rows.append(row)

    # (label, B, KV, g, S, hd, pos, dtype, window, garbage past pos, timed)
    decode_cases = [
        ("decode", 8, 8, 2, 576, 128, 575, "bfloat16", 0, False, True),
        ("long_decode", 8, 8, 2, 4096, 128, 4095, "bfloat16", 0, False, True),
        ("edge_pos0", 8, 8, 2, 576, 128, 0, "bfloat16", 0, True, False),
        ("edge_garbage_past_pos", 8, 8, 2, 576, 128, 300, "bfloat16", 0, True, False),
        ("edge_window_64", 2, 8, 2, 576, 128, 400, "bfloat16", 64, True, False),
        ("edge_hd64", 2, 4, 4, 256, 64, 100, "float32", 0, True, False),
        ("edge_hd32", 2, 2, 8, 128, 32, 127, "float32", 0, False, False),
        ("edge_g1", 2, 8, 1, 576, 128, 575, "bfloat16", 0, False, False),
        ("edge_one_row", 1, 8, 2, 1, 128, 0, "bfloat16", 0, False, False),
        ("edge_g6", 2, 2, 6, 300, 128, 299, "float32", 0, False, False),
        ("edge_pos_cta_boundary", 8, 8, 2, 576, 128, 288, "bfloat16", 0, True, False),
        ("edge_window_across_ctas", 2, 8, 2, 576, 128, 300, "bfloat16", 100, True, False),
        # gemma3-12b (phase 7): its decode at the last step's pos, global and local
        ("gemma3_decode", 4, 8, 2, 2080, 256, 2079, "bfloat16", 0, False, True),
        ("gemma3_decode_local", 4, 8, 2, 2080, 256, 2079, "bfloat16", 1024, False, True),
        ("edge_hd256_f32", 4, 8, 2, 2080, 256, 2079, "float32", 0, True, False),
        ("edge_hd256_g1", 1, 8, 1, 576, 256, 300, "bfloat16", 0, True, False),
        ("edge_hd256_g8", 1, 2, 8, 576, 256, 575, "bfloat16", 100, False, False),
        ("edge_hd256_window_across_ctas", 2, 8, 2, 2080, 256, 1500, "bfloat16", 1024, True,
         False),
        # Zamba2-1.2B (phase 11): the shared block's decode at the last step's pos
        # (256 + 32 rows, group 1)
        ("zamba2_decode", 8, 32, 1, 288, 128, 287, "bfloat16", 0, False, True),
        # llava-next-mistral-7b (phase 14): the engine's last step (512 + 64 rows,
        # group 4, the window 4096)
        ("llava_decode", 8, 8, 4, 576, 128, 575, "bfloat16", 4096, False, True),
        # whisper-medium (phase 15): the last step's self-attention over the
        # 128-row cache (pos 126), and cross-attention over all 1,500 encoder
        # states (group 1, hd 64)
        ("whisper_self_decode", 8, 16, 1, 128, 64, 126, "bfloat16", 0, False, True),
        ("whisper_cross_decode", 8, 16, 1, 1500, 64, 1499, "bfloat16", 0, False, True),
        # kimi-k2-1t (phase 18): the engine's last step, group 8 of head width 112;
        # deepseek-v3-671b (phase 19): the absorbed MLA decode, 128 heads over one
        # cache head of 576-wide rows (latent ++ k_rope), V the rows' first 512
        # columns, scale 192^-1/2
        ("kimi_decode", 8, 8, 8, 576, 112, 575, "bfloat16", 0, False, True),
        ("deepseek_mla_decode", 8, 1, 128, 576, 576, 575, "bfloat16", 0, False, True, 512),
        ("edge_hd112_pos0", 8, 8, 8, 576, 112, 0, "bfloat16", 0, True, False),
        ("edge_hd112_window", 2, 8, 8, 576, 112, 400, "bfloat16", 100, True, False),
        ("edge_hd112_f32", 2, 8, 8, 300, 112, 299, "float32", 0, True, False),
        ("edge_mla_pos0", 8, 1, 128, 576, 576, 0, "bfloat16", 0, True, False, 512),
        ("edge_mla_pos_in_first_tile", 8, 1, 128, 576, 576, 17, "bfloat16", 0, True, False, 512),
        ("edge_mla_ragged", 2, 1, 16, 100, 576, 99, "bfloat16", 0, False, False, 512),
    ]
    decode_rows = []
    for label, B, KV, g, S, hd, pos, dt, window, garbage, timed, *dv in decode_cases:
        # MLA (dv given): V is the first dv columns of K's rows, at scale 192^-1/2
        dv, scale = (dv[0], 192 ** -0.5) if dv else (hd, None)
        q = randn((B, KV * g, hd), dt)
        k = randn((B, KV, S, hd), dt)
        v = k[..., :dv] if dv != hd else randn((B, KV, S, hd), dt)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = ops.decode_attention(q, k, v, p, window=window, scale=scale)
        torch.cuda.synchronize()
        plain = ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, p, window=window,
                                         scale=scale).reshape(B, KV * g, dv)
        cluster, keys = decode_attention.geometry(
            B, KV, g, S, torch.cuda.get_device_properties(dev).multi_processor_count, hd)
        row = {"case": label, "shape": {"q": [B, KV * g, hd], "kv": [B, KV, S, hd]},
               "dtype": dt, "pos": pos, "window": window, "cluster": cluster,
               "keys_per_cta": keys}
        if dv != hd:
            row["shape"]["v"] = f"k[..., :{dv}]"
            row["scale"] = scale
        if garbage:  # rows past pos are never read: NaN there changes nothing
            k2 = k.clone()
            v2 = k2[..., :dv] if dv != hd else v.clone()
            k2[:, :, pos + 1:] = float("nan")
            if dv == hd:
                v2[:, :, pos + 1:] = 1e30
            again = ops.decode_attention(q, k2, v2, p, window=window, scale=scale)
            torch.cuda.synchronize()
            row["garbage_past_pos_equal"] = bool(torch.equal(again, out))
            if not row["garbage_past_pos_equal"]:
                raise SystemExit(f"chip_smoke: decode_attention read rows past pos: {row}")
        if timed:
            lo = max(0, pos - window + 1) if window else 0
            live = pos - lo + 1
            esize = q.element_size()
            # q and the output once, each live K row once and each live V row once
            # (MLA: V lies in K's rows, read once with them)
            kv_row = hd + (dv if dv == hd else 0)
            nbytes = (q.numel() + out.numel() + B * KV * live * kv_row) * esize
            flops = 2 * (hd + dv) * B * KV * g * live
            kpos = torch.arange(S, device=dev)
            mask = (kpos <= p) & (kpos > p - window) if window else kpos <= p
            mask = mask.view(1, 1, 1, S)
            q4 = q.view(B, KV * g, 1, hd)
            row.update(_timings(
                torch,
                lambda: ops.decode_attention(q, k, v, p, window=window, scale=scale),
                lambda: ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, p, window=window,
                                                 scale=scale),
                lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True,
                                                       scale=scale),
                flush, nbytes, flops, events=1,
            ))
        _check_close(torch, "decode_attention", row, out, plain)
        decode_rows.append(row)
    return flash_rows, decode_rows


# --------------------------------------------------------------- phase 3c
def phase_ssd(torch) -> list:
    """``ssd_scan`` against its plain version on the card."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # (label, B, H, L, P, N, chunk, dtype, dtA range, timed). dtA at the model's
    # scales (dt about 0.7, A in [-16, -1]) decays the state to nothing within a
    # chunk; the slow-decay rows keep every chunk's state alive to the end.
    model_decay, slow = (0.5, 8.0), (0.0, 0.01)
    cases = [
        ("serving", 8, 48, 512, 64, 128, 128, "bfloat16", model_decay, True),
        ("long_prompt", 1, 48, 4096, 64, 128, 128, "bfloat16", model_decay, True),
        ("edge_jax_sweep", 1, 2, 128, 32, 16, 32, "float32", (0.0, 0.3), False),
        ("edge_jax_sweep", 2, 3, 256, 64, 32, 64, "float32", (0.0, 0.3), False),
        ("edge_jax_sweep_one_chunk", 1, 1, 64, 16, 8, 64, "float32", (0.0, 0.3), False),
        ("edge_q100", 2, 48, 100, 64, 128, 128, "bfloat16", model_decay, False),
        ("edge_single_chunk", 2, 48, 128, 64, 128, 128, "bfloat16", model_decay, False),
        ("edge_slow_decay", 2, 48, 512, 64, 128, 128, "bfloat16", slow, False),
        ("edge_slow_decay_f32", 1, 4, 4096, 64, 128, 128, "float32", slow, False),
        ("edge_zamba2_widths", 2, 64, 256, 64, 64, 128, "bfloat16", model_decay, False),
        # Zamba2-1.2B's model.prefill (phase 11): 8 prompts of 256 tokens
        ("zamba2_prefill", 8, 64, 256, 64, 64, 128, "bfloat16", model_decay, True),
    ]
    rows = []
    for label, B, H, L, P, N, chunk, dt, (lo, hi), timed in cases:
        def randn(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtypes[dt])

        x, Bm, Cm = randn(B, H, L, P), randn(B, L, N), randn(B, L, N)
        dtA = -(lo + (hi - lo) * torch.rand((B, H, L), generator=gen, device=dev))
        Q = min(chunk, L)
        y, state = ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        want, want_state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=Q)
        rtol, atol = SSD_TOL[dt]
        if dt == "bfloat16":
            atol *= float(want.float().abs().max())
        state_tol = SSD_STATE_TOL * max(1.0, float(want_state.abs().max()))
        row = {"case": label, "shape": {"x": [B, H, L, P], "BC": [B, L, N]}, "chunk": Q,
               "n_chunks": L // Q, "dtype": dt, "dtA": [-hi, -lo],
               "max_abs_err": float((y.float() - want.float()).abs().max()),
               "tolerance": {"rtol": rtol, "atol": atol},
               "state_max_abs_err": float((state - want_state).abs().max()),
               "state_tolerance": {"rtol": SSD_STATE_TOL, "atol": state_tol}}
        ok = bool(torch.allclose(y.float(), want.float(), rtol=rtol, atol=atol)) and \
            bool(torch.allclose(state, want_state, rtol=SSD_STATE_TOL, atol=state_tol))
        if timed:
            esize = x.element_size()
            # x, dtA, B and C read once; y and the f32 final state (the prefill
            # asks for it) written once
            nbytes = 2 * x.numel() * esize + dtA.numel() * 4 + 2 * Bm.numel() * esize \
                + state.numel() * 4
            pairs = Q * (Q + 1) // 2  # (i, j <= i) pairs of a chunk's causal mask
            n_chunks = L // Q
            # C·Bᵀ once per (batch, chunk); per (batch, head, chunk) the masked
            # scores times x, C times the state, and x's decayed outer product with B
            flops = 2 * B * n_chunks * (pairs * N + H * (pairs * P + 2 * Q * P * N))
            row.update(_timings(
                torch,
                lambda: ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True),
                lambda: ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=Q),
                None, flush, nbytes, flops,
            ))
        log(f"[kernels] ssd_scan {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"chip_smoke: ssd_scan differs from its plain version: {row}")
        rows.append(row)
    return rows


def _ssd_bwd_work(B: int, H: int, L: int, P: int, N: int, Q: int, esize: int) -> tuple:
    """Bytes and operations the scan's backward needs for this input: x, dy
    and dx, B, C, dB and dC at the inputs' width, dtA and its gradient in
    f32, once each; C·Bᵀ once per (batch, chunk) over the causal pairs, and
    per (batch, head, chunk) dy·xᵀ, (G ⊙ L)ᵀ·dy, (dS ⊙ L)·B and (dS ⊙ L)ᵀ·C over
    the pairs and six Q·P·N products (the state, its gradient, and the
    state terms of dx, dB, dC and d(dtA)), two operations a multiply-add."""
    nc, pairs = L // Q, Q * (Q + 1) // 2
    nbytes = 3 * B * H * L * P * esize + 2 * B * H * L * 4 + 4 * B * L * N * esize
    flops = 2 * B * nc * (pairs * N + H * (2 * pairs * P + 2 * pairs * N + 6 * Q * P * N))
    return nbytes, flops


def phase_ssd_bwd(torch) -> list:
    """The scan's backward kernels (``csrc/ssd_scan_bwd.cu``: bf16 on the
    tensor cores, f32 on the SIMT pipes) against their plain version
    (``ref.ssd_scan_bwd_ref``) on the card: dx, d(dtA), dB and dC within
    ``BWD_TOL`` of each one's largest entry, two calls bit-equal, every bf16
    call on the tensor-core kernels (``bwd_tc_launches``); at the training
    shapes (phases 22-23) the device time beside the plain version's and the
    bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    model_decay, slow = (0.5, 8.0), (0.0, 0.01)
    # (label, B, H, L, P, N, chunk, dtype, dtA range, timed)
    cases = [
        ("mamba2_train", 4, 48, 2048, 64, 128, 128, "bfloat16", model_decay, True),
        ("zamba2_train", 4, 64, 2048, 64, 64, 128, "bfloat16", model_decay, True),
        ("edge_q100", 2, 48, 200, 64, 128, 100, "bfloat16", model_decay, False),
        ("edge_slow_decay", 2, 48, 512, 64, 128, 128, "bfloat16", slow, False),
        # P 32 at N 16 and 32, Q 100, heads that are not a multiple of the group of 8
        ("edge_p32_n16_q100_h9", 2, 9, 200, 32, 16, 100, "bfloat16", model_decay, False),
        ("edge_p32_n32_q100_h12", 2, 12, 200, 32, 32, 100, "bfloat16", model_decay, False),
        ("edge_f32_n128_slow", 1, 4, 512, 64, 128, 128, "float32", slow, False),
        ("edge_f32_n64_q40", 2, 4, 240, 64, 64, 40, "float32", model_decay, False),
        ("edge_reduced_widths", 2, 8, 96, 32, 16, 32, "float32", (0.0, 0.3), False),
    ]
    rows = []
    for label, B, H, L, P, N, chunk, dt, (lo, hi), timed in cases:
        def randn(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtypes[dt])

        x, dy, Bm, Cm = randn(B, H, L, P), randn(B, H, L, P), randn(B, L, N), randn(B, L, N)
        dtA = -(lo + (hi - lo) * torch.rand((B, H, L), generator=gen, device=dev))
        tc_before = ssd.bwd_tc_launches
        got = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=chunk)
        again = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=chunk)
        torch.cuda.synchronize()
        tc_calls = ssd.bwd_tc_launches - tc_before
        want = ref.ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, chunk=chunk)
        errs = {name: float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for name, g, w in zip(("dx", "ddtA", "dB", "dC"), got, want)}
        bit_equal = all(bool(torch.equal(g, g2)) for g, g2 in zip(got, again))
        row = {"case": label, "shape": {"x": [B, H, L, P], "BC": [B, L, N]}, "chunk": chunk,
               "n_chunks": L // chunk, "dtype": dt, "dtA": [-hi, -lo],
               "rel_err": errs, "max_abs_err": max(
                   float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)),
               "tolerance": BWD_TOL[dt], "bit_equal": bit_equal, "tc_launches": tc_calls}
        del got, again, want
        if timed:
            nbytes, flops = _ssd_bwd_work(B, H, L, P, N, chunk, x.element_size())
            row.update(_timings(
                torch, lambda: ssd.ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=chunk),
                lambda: ref.ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, chunk=chunk),
                None, flush, nbytes, flops,
                peak=BF16_FLOPS if dt == "bfloat16" else F32_FLOPS))
        log(f"[kernels] ssd_scan_bwd {json.dumps(row)}")
        if not bit_equal or max(errs.values()) > BWD_TOL[dt]:
            raise SystemExit(f"chip_smoke: ssd_scan_bwd differs from its plain version or "
                             f"from itself: {row}")
        if tc_calls != (2 if dt == "bfloat16" else 0):
            raise SystemExit(f"chip_smoke: ssd_scan_bwd's bf16 calls did not all run on the "
                             f"tensor cores (and f32 ones none): {row}")
        rows.append(row)
        del x, dy, Bm, Cm, dtA
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3d
#: the most bytes one (Sq, Sk) f32 score tensor of a plain attention call may
#: take in phase 3d (llava's, 4.3 GB, is whole); past it the plain versions run
#: a group of KV heads (with their q heads) at a time. The first-step gates,
#: beside a model and its gradients, take a quarter of it
PLAIN_BYTES = 2 ** 32


def _plain_heads(B: int, H: int, KV: int, Sq: int, Sk: int, budget: int = PLAIN_BYTES):
    """q heads a plain attention call takes at once (whole KV groups), or
    None where the whole call's scores fit ``budget`` bytes."""
    g = H // KV
    if B * H * Sq * Sk * 4 <= budget:
        return None
    return max(g, budget // (B * Sq * Sk * 4) // g * g)


def _by_heads(torch, fn, heads, q, k, v):
    """``fn(q, k, v)`` a group of ``heads`` q heads (and their KV heads) at a
    time, each output concatenated over its head axis. Under grad each group
    runs under ``torch.utils.checkpoint``, so only its inputs stay for the
    backward."""
    from torch.utils.checkpoint import checkpoint

    outs = []
    for h0 in range(0, q.shape[1], heads):
        args = _head_slices(q, k, (v,), h0, heads)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        outs.append(checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def _plain_fwd(torch, q, k, v, causal, window, heads):
    """``ref.flash_attention_ref``'s output and LSE, ``heads`` q heads a call."""
    from repro_torch.kernels import ref

    def fn(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)

    return fn(q, k, v) if heads is None else _by_heads(torch, fn, heads, q, k, v)


def _plain_bwd(torch, q, k, v, out, do, lse, causal, window, heads, scale=None):
    """``ref.flash_attention_bwd_ref``, ``heads`` q heads a call: dq by q
    heads, dk and dv by KV heads (each KV head's group is whole in a call)."""
    from repro_torch.kernels import ref

    def fn(q, k, v, out, do, lse):
        return ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window,
                                           scale=scale)

    if heads is None:
        return fn(q, k, v, out, do, lse)
    with torch.no_grad():
        dq, dk, dv = zip(*(fn(*_head_slices(q, k, (v, out, do, lse), h0, heads))
                           for h0 in range(0, q.shape[1], heads)))
    return torch.cat(dq, dim=1), torch.cat(dk, dim=1), torch.cat(dv, dim=1)


def _head_slices(q, k, rest, h0, heads):
    """q heads [h0, h0 + heads) and their KV heads: (q, k, v, *rest by q heads)."""
    g = q.shape[1] // k.shape[1]
    kv = slice(h0 // g, (h0 + heads) // g)
    v, *by_q = rest
    return (q[:, h0:h0 + heads], k[:, kv], v[:, kv], *(t[:, h0:h0 + heads] for t in by_q))


def phase_attention_bwd(torch) -> list:
    """The backward of ``flash_attention`` against its plain version on the
    card, at the training shapes (timed) and at edge shapes; Sq q rows over
    Sk keys, the mask top-left aligned."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dtype])

    # (label, B, H, KV, Sq, Sk, hd, dtype, causal, window, timed)
    cases = [
        ("paper_lm_train", 8, 4, 4, 256, 256, 64, "float32", True, 0, True),
        ("internlm2_train", 4, 16, 8, 2048, 2048, 128, "bfloat16", True, 0, True),
        # gemma3-12b's training shapes (phase 10): its local and its global layers
        ("gemma3_train_local", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 1024, True),
        ("gemma3_train_global", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 0, True),
        # whisper-medium's training shapes (phase 16): the encoder over the 1,500
        # frames, the cross-attention of the 448 text rows over them, the decoder
        ("whisper_encoder_train", 8, 16, 16, 1500, 1500, 64, "bfloat16", False, 0, True),
        ("whisper_cross_train", 8, 16, 16, 448, 1500, 64, "bfloat16", False, 0, True),
        ("whisper_decoder_train", 8, 16, 16, 448, 448, 64, "bfloat16", True, 0, True),
        # llava-next-mistral-7b's (phase 17): 1,152 patches + 2,944 tokens, window 4,096
        ("llava_train", 2, 32, 8, 4096, 4096, 128, "bfloat16", True, 4096, True),
        # the moe family's (phases 20-21), a (q·k, v) pair: kimi-k2-1t's GQA, 64 heads
        # over 8 of width 112; deepseek-v3's expanded MLA, 128 heads at (192, 128)
        ("kimi_k2_train", 2, 64, 8, 4096, 4096, (112, 112), "bfloat16", True, 0, True),
        ("deepseek_mla_train", 2, 128, 128, 4096, 4096, (192, 128), "bfloat16", True, 0, True),
        ("edge_ragged", 2, 16, 8, 300, 300, 128, "bfloat16", True, 0, False),
        ("edge_64_row_tiles", 2, 16, 8, 192, 192, 128, "bfloat16", True, 0, False),
        ("edge_hd256_ragged", 2, 16, 8, 300, 300, 256, "bfloat16", True, 0, False),
        ("edge_hd256_window_ragged", 1, 16, 8, 2100, 2100, 256, "bfloat16", True, 1024, False),
        ("edge_hd256_g4", 1, 4, 1, 65, 65, 256, "bfloat16", True, 0, False),
        ("edge_ragged_f32", 2, 4, 2, 300, 300, 64, "float32", True, 0, False),
        ("edge_window_1024", 2, 16, 8, 2048, 2048, 128, "bfloat16", True, 1024, False),
        ("edge_hd32", 2, 4, 2, 100, 100, 32, "float32", True, 0, False),
        ("edge_hd32_bf16", 2, 8, 1, 130, 130, 32, "bfloat16", True, 0, False),
        ("edge_g1", 2, 4, 4, 256, 256, 128, "bfloat16", True, 0, False),
        ("edge_g2", 2, 8, 4, 200, 200, 64, "float32", True, 64, False),
        ("edge_g8", 1, 8, 1, 130, 130, 64, "float32", True, 0, False),
        ("edge_f32_hd128_window", 2, 4, 2, 129, 129, 128, "float32", True, 64, False),
        ("edge_noncausal", 1, 4, 4, 200, 200, 64, "float32", False, 0, False),
        # Sq != Sk: causal both ways (Sk > Sq leaves keys no row sees: exact zeros),
        # one row over the 1,500 frames, a window, f32 at hd 64 and 128
        ("edge_sq_gt_sk_causal", 1, 8, 4, 300, 130, 128, "bfloat16", True, 0, False),
        ("edge_sk_gt_sq_causal", 1, 8, 4, 130, 400, 128, "bfloat16", True, 0, False),
        ("edge_sk_gt_sq_causal_hd256", 1, 8, 4, 70, 300, 256, "bfloat16", True, 0, False),
        ("edge_sq1_sk1500", 2, 16, 16, 1, 1500, 64, "bfloat16", False, 0, False),
        ("edge_sq_lt_sk_window", 1, 8, 4, 300, 700, 128, "bfloat16", True, 100, False),
        ("edge_sq_gt_sk_window", 1, 8, 4, 420, 300, 64, "bfloat16", True, 128, False),
        ("edge_f32_sq_ne_sk_hd64", 1, 4, 2, 130, 300, 64, "float32", False, 0, False),
        ("edge_f32_sq_ne_sk_hd128", 1, 4, 2, 200, 90, 128, "float32", True, 0, False),
        ("edge_f32_sk_gt_sq_causal", 1, 4, 2, 64, 200, 64, "float32", True, 0, False),
        # bf16 non-causal (whisper's encoder and cross-attention), ragged on both sides
        ("edge_bf16_noncausal_hd32", 1, 4, 2, 300, 300, 32, "bfloat16", False, 0, False),
        ("edge_bf16_noncausal_hd128", 1, 8, 4, 333, 333, 128, "bfloat16", False, 0, False),
        ("edge_bf16_noncausal_hd256", 1, 8, 4, 300, 300, 256, "bfloat16", False, 0, False),
        # llava's window where it bites: 4,352 positions, keys 4,096 back drop out
        ("llava_window_bites", 1, 32, 8, 4352, 4352, 128, "bfloat16", True, 4096, False),
        # the moe pairs' edges: ragged Sq, Sq != Sk both ways (Sk > Sq causal: keys no
        # row sees, exact zeros), non-causal; 112 in a group of 8, the MLA's group of 1
        ("edge_112_ragged", 2, 16, 2, 300, 300, (112, 112), "bfloat16", True, 0, False),
        ("edge_112_sk_gt_sq_causal", 1, 8, 1, 130, 400, (112, 112), "bfloat16", True, 0, False),
        ("edge_112_sq_gt_sk_causal", 1, 8, 1, 400, 130, (112, 112), "bfloat16", True, 0, False),
        ("edge_112_noncausal", 1, 8, 2, 333, 500, (112, 112), "bfloat16", False, 0, False),
        ("edge_mla_ragged", 2, 16, 16, 300, 300, (192, 128), "bfloat16", True, 0, False),
        ("edge_mla_sk_gt_sq_causal", 1, 8, 8, 130, 400, (192, 128), "bfloat16", True, 0, False),
        ("edge_mla_sq_gt_sk_causal", 1, 8, 8, 400, 130, (192, 128), "bfloat16", True, 0, False),
        ("edge_mla_noncausal", 1, 8, 8, 333, 500, (192, 128), "bfloat16", False, 0, False),
    ]
    rows = []
    for label, B, H, KV, Sq, Sk, hd, dt, causal, window, timed in cases:
        dk, dv = hd if isinstance(hd, tuple) else (hd, hd)
        q, do = randn((B, H, Sq, dk), dt), randn((B, H, Sq, dv), dt)
        k, v = randn((B, KV, Sk, dk), dt), randn((B, KV, Sk, dv), dt)
        # the forward's output in f32, as the training forward keeps it for D
        out, lse, out32 = flash_attention.flash_attention_fwd(
            q, k, v, causal=causal, window=window, return_lse=True)
        # the plain versions a head group at a time where a call's (Sq, Sk) scores
        # would pass PLAIN_BYTES (the MLA's would be 17 GB a tensor)
        heads = _plain_heads(B, H, KV, Sq, Sk)
        plain_out, plain_lse = _plain_fwd(torch, q, k, v, causal, window, heads)

        def kernel():
            return flash_attention.flash_attention_bwd(q, k, v, out32, do, lse, causal=causal,
                                                       window=window)

        def plain_fn():
            return _plain_bwd(torch, q, k, v, out32, do, lse, causal, window, heads)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain_fn()
        tol = BWD_TOL[dt]
        rel = {n: float((g.float() - w.float()).abs().max() / w.float().abs().max())
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        row = {"case": label, "shape": {"q": [B, H, Sq, dk], "k": [B, KV, Sk, dk],
                                        "v": [B, KV, Sk, dv]},
               "dtype": dt, "causal": causal, "window": window,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "max_rel_err": rel, "tolerance": tol,
               "lse_max_abs_err": float((lse - plain_lse).abs().max()),
               "bit_equal_repeat": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
               "out_f32_rounds_to_out": bool(torch.equal(out32.to(out.dtype), out)),
               "fwd_max_abs_err": float((out.float() - plain_out.float()).abs().max()),
               "fwd_close": bool(torch.allclose(out.float(), plain_out.float(),
                                                rtol=ATTN_TOL[dt], atol=ATTN_TOL[dt]))}
        if causal and Sk > Sq:  # keys past Sq: no row sees them, dk and dv exactly 0
            row["unseen_keys_zero"] = not (got[1][:, :, Sq:].any() or got[2][:, :, Sq:].any())
        if heads is not None:
            row["plain_heads_per_call"] = heads
        if timed:
            esize = q.element_size()
            # q, k, v, O, dO and the LSE read once, O at q's dtype as the function's
            # output (this kernel's f32 read of it is its own choice, not the
            # function's need); dq, dk, dv written once
            nbytes = 2 * (q.numel() + do.numel() + k.numel() + v.numel()) * esize \
                + lse.numel() * 4
            # 2.5 × the masked forward's 2·B·H·live·(dk + dv), at the true widths
            flops = int(2.5 * 2 * (dk + dv) * B * H * _live_pairs(Sq, Sk, causal, window))
            g = H // KV
            qs = q.detach().clone().requires_grad_()
            ks = k.repeat_interleave(g, dim=1).requires_grad_()
            vs = v.repeat_interleave(g, dim=1).requires_grad_()
            if window > 0:
                pos = torch.arange(Sq, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
            else:  # is_causal aligns top-left, as the kernel's mask does
                o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            library = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do, retain_graph=True)
            try:  # SDPA is a yardstick only: where no backend takes the shape, none
                library()
            except RuntimeError as err:  # includes torch.OutOfMemoryError
                row["library_refused"] = str(err)[:300]
                library = None
                torch.cuda.empty_cache()
            row.update(_timings(torch, kernel, plain_fn, library, flush, nbytes, flops,
                                peak=BF16_FLOPS if dt == "bfloat16" else F32_FLOPS))
            row["peak_flops"] = BF16_FLOPS if dt == "bfloat16" else F32_FLOPS
            # the training forward (the LSE, O in f32 and, in bf16, the product of
            # P − bf16(P)) beside the serving forward on the same inputs
            for key, lse_too in (("train_fwd_ms", True), ("serve_fwd_ms", False)):
                row[key] = _device_ms(torch, lambda lse_too=lse_too: (
                    flash_attention.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                        return_lse=lse_too)), flush)
            del qs, ks, vs, o_lib
        log(f"[kernels] flash_attention_bwd {json.dumps(row)}")
        ok = all(r <= tol for r in rel.values()) and row["bit_equal_repeat"] and \
            row["lse_max_abs_err"] <= 1e-3 and row.get("unseen_keys_zero", True) and \
            row["out_f32_rounds_to_out"] and row["fwd_close"]
        if not ok:
            raise SystemExit(f"chip_smoke: flash_attention_bwd differs from its plain version: "
                             f"{row}")
        rows.append(row)
        del q, k, v, do, out, out32, lse, plain_out, got, again, want
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 4
def _build_dataset(root: str, n: int, hw: int, seed: int, chunk: int) -> float:
    import numpy as np
    from repro_torch.data import DatasetBuilder

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    b = DatasetBuilder(
        root,
        {"image": ((hw, hw, 3), "float32"), "label": ((), "int32")},
        quantize={"image": ("u8", 0.0, 1.0)},
    )
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        b.append(
            image=rng.random((m, hw, hw, 3), dtype=np.float32),
            label=rng.integers(0, 10, m).astype(np.int32),
        )
    b.finish()
    return time.perf_counter() - t0


def _drive(torch, root: str, batch: int, nbatches: int, host_root: str | None = None) -> dict:
    """One run of the device feed: ``nbatches`` batches through the port's
    DeviceLoader with the launch count read just before and just after,
    then every batch held against the host decode of the same batch (read
    from ``host_root``, by default ``root`` itself)."""
    import numpy as np
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.kernels import dequant_u8

    feed = DeviceLoader(DataLoader(RaDataset(root), batch, seed=SEED, reuse_buffers=True))
    if feed.device.type != "cuda":
        raise SystemExit(f"chip_smoke: DeviceLoader defaulted to {feed.device}, not the card")
    dequant_u8.launches = 0
    t0 = time.perf_counter()
    got = [next(feed) for _ in range(nbatches)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feed.stop()  # the feeder runs ahead by at most bufs + 1 batches; stopped here
    launches = dequant_u8.launches
    stats = feed.stats()

    host = DataLoader(RaDataset(host_root or root), batch, seed=SEED, dequant=True)
    try:
        for i, db in enumerate(got):
            hb = next(host)
            if hb["_state"].__dict__ != db["_state"].__dict__:
                raise SystemExit(f"chip_smoke: batch {i} state {db['_state']} != {hb['_state']}")
            for f in ("image", "label"):
                if db[f].device.type != "cuda":
                    raise SystemExit(f"chip_smoke: batch {i} {f} is on {db[f].device}")
                if not torch.equal(db[f].cpu(), torch.from_numpy(np.asarray(hb[f]))):
                    raise SystemExit(f"chip_smoke: batch {i} field {f} differs from the host decode")
    finally:
        host.stop()

    moved = int(stats["h2d_batches"])
    per_batch = stats["h2d_bytes"] / stats["h2d_batches"]
    row_bytes = got[0]["image"][0].numel() + 4  # u8 codes + int32 label
    out = {
        "batches": nbatches,
        "batch": batch,
        "consumed": int(stats["device_batches"]),
        "moved": moved,
        "launches": launches,
        "seconds": seconds,
        "batches_per_s": nbatches / seconds,
        "h2d_bytes_per_batch": per_batch,
        "h2d_gb_per_s": stats["h2d_bytes"] / stats["h2d_s"] / 1e9,
        "h2d_s": stats["h2d_s"],
        "device_wait_s": stats["device_wait_s"],
        "loader_produce_s": stats["loader_produce_s"],
    }
    if out["consumed"] != nbatches:
        raise SystemExit(f"chip_smoke: consumed {out['consumed']} batches, wanted {nbatches}")
    # one decode launch per batch the feed moved: the consumed ones plus the
    # few the feeder had moved ahead when it was stopped
    if launches != moved or not nbatches <= moved <= nbatches + feed.bufs + 1:
        raise SystemExit(f"chip_smoke: {launches} launches for {moved} moved batches "
                         f"({nbatches} consumed)")
    if per_batch != batch * row_bytes:
        raise SystemExit(f"chip_smoke: {per_batch} h2d bytes per batch, wanted {batch * row_bytes}")
    return out


def phase_main_path(torch, keep: str) -> list:
    """The device feed; the CIFAR-10-shaped dataset stays in ``keep`` for
    phase 12's URL feed."""
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, n, hw, batch, nbatches, chunk in (
            ("cifar10_epoch", 50_000, 32, 512, 50_000 // 512, 5_000),
            ("imagenet_8_batches", 2_048, 224, 256, 8, 256),
        ):
            root = os.path.join(keep if name == "cifar10_epoch" else tmp, name)
            build_s = _build_dataset(root, n, hw, SEED, chunk)
            run = _drive(torch, root, batch, nbatches)
            run.update(name=name, rows=n, image=[hw, hw, 3], dataset_build_s=build_s)
            log(f"[main path] {json.dumps(run)}")
            runs.append(run)
    return runs


# --------------------------------------------------------------- phase 5
def _temper_attention(torch, model) -> None:
    """Rescale the random attention projections to their contraction fan-in
    (for Zamba2 those of its shared block, which attends over
    ``concat([x, x0])``, 2·d_model wide; for Whisper all three kinds: the
    encoder's, the decoder's self-attention and its cross-attention).

    The JAX package's ``Initializer.fanin`` (which the port's init follows)
    divides by ``shape[-2]``: the head count for ``wq``/``wk``/``wv``
    ``(d, heads, hd)`` and ``hd`` for ``wo`` ``(H, hd, d)``. At InternLM2's
    widths q and k then have a std near 11 and 16, q·k/sqrt(hd) near 180,
    softmax is all but an argmax, and the random 24-layer model is chaotic:
    a 1e-7 difference at layer 0 grows about 20x a layer, so no two attention
    implementations agree on its logits, f32 or bf16. Scaled by
    ``1/sqrt(d_model)`` (``1/sqrt(H*hd)`` for ``wo``) instead, scores have a
    std near 1 and the comparison below is meaningful.

    The moe family: both stacks (``dense_layers``, ``moe_layers``) and
    DeepSeek-V3's MTP layer. MLA's
    ``wq_b`` (q_lora, H, 192) and ``wkv_b`` (kv_lora, H, 256) are divided by
    the head count too, where their contraction is the rank (1,536, 512),
    and ``wo`` (H, 128, d) by 128 where it contracts all H·128; ``wq_a`` and
    ``wkv_a`` (d, rank) are at their fan-in already."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        attns, d = [model.shared.attn], 2 * cfg.d_model
    elif cfg.family == "encdec":
        attns = [model.enc_layers.attn, model.dec_layers.self_attn, model.dec_layers.cross_attn]
        d = cfg.d_model
    else:
        attns = [getattr(model, stack).attn for stack in ("dense_layers", "moe_layers")
                 if hasattr(model, stack)]
        if cfg.mtp:  # DeepSeek-V3's MTP layer: trained (phase 21), not served
            attns.append(model.mtp.layer.attn)
        d = cfg.d_model
    H, KV = cfg.n_heads + cfg.head_pad, cfg.n_kv_heads
    with torch.no_grad():
        if cfg.attn_type == "mla":
            m = cfg.mla
            for a in attns:
                a.wq_b.mul_((H / m.q_lora_rank) ** 0.5)
                a.wkv_b.mul_((H / m.kv_lora_rank) ** 0.5)
                a.wo.mul_((1 / H) ** 0.5)
            return
        for a in attns:
            a.wq.mul_((H / d) ** 0.5)
            a.wk.mul_((KV / d) ** 0.5)
            a.wv.mul_((KV / d) ** 0.5)
            a.wo.mul_((1 / H) ** 0.5)


def _score_std(torch, model, tokens) -> float:
    """Std of layer 0's attention scores q·k/sqrt(hd) (q head 0 against KV
    head 0) over ``tokens``: how sharp the random model's softmax is."""
    from repro_torch.models.common import rmsnorm

    a = model.dense_layers.attn
    with torch.inference_mode():
        h = rmsnorm(model._embed_inputs(tokens), model.dense_layers.ln_attn.scale[0])[0].float()
        q = h @ a.wq[0, :, 0, :].float()
        k = h @ a.wk[0, :, 0, :].float()
        return float((q @ k.t() / q.shape[-1] ** 0.5).std())


@contextlib.contextmanager
def _plain_attention(heads=None):
    """The serving path with both attention ops swapped for their plain
    versions, for this script's comparison only; with ``heads``, the flash
    op's plain version ``heads`` q heads at a time (``_by_heads``)."""
    import torch

    from repro_torch.kernels import ops, ref

    kept = ops.flash_attention, ops.decode_attention

    # the ops' own signatures: an argument the plain versions would drop raises
    def flash(q, k, v, *, causal=True, window=0, block_q=128, block_k=128):
        def fn(q, k, v):
            return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

        return fn(q, k, v) if heads is None else _by_heads(torch, fn, heads, q, k, v)

    def decode(q, k, v, pos, *, window=0, block_s=512, scale=None):
        B, H, hd = q.shape
        KV = k.shape[1]
        out = ref.decode_attention_ref(q.reshape(B, KV, H // KV, hd), k, v, pos, window=window,
                                       scale=scale)
        return out.reshape(B, H, out.shape[-1])

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = kept


def phase_serving(torch, keep: str) -> dict:
    """InternLM2-1.8B: checkpoint, cold start, and a batch of requests. The
    raw and u8 checkpoints stay in ``keep`` for phase 12, which also reads
    the greedy tokens (``out["tokens"]``, left out of the log line)."""
    import numpy as np

    from repro_torch.checkpoint import ColdStartStats, load_checkpoint, restore_pipelined
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S, max_new = 8, 512, 64
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    probe = torch.randint(1, cfg.vocab, (1, 256), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    out["score_std_at_init_scales"] = _score_std(torch, model, probe)
    _temper_attention(torch, model)
    out["score_std"] = _score_std(torch, model, probe)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the checks
    out["params"] = sum(t.numel() for t in saved.values())
    float_leaves = sum(1 for t in saved.values() if t.is_floating_point() and t.dim())

    t0 = time.perf_counter()
    raw = save_checkpoint(os.path.join(keep, "raw"), 1, model.param_tree())
    out["save_raw_s"] = time.perf_counter() - t0
    # the u8 checkpoint is of an f32 copy (a training checkpoint's dtype):
    # under quantize="u8" bf16 leaves are stored verbatim, as the JAX
    # package stores them, and f32 ones become codes the kernel decodes
    t0 = time.perf_counter()
    f32 = _float32(torch, model.param_tree())
    u8 = save_checkpoint(os.path.join(keep, "u8"), 1, f32, quantize="u8")
    del f32
    out["save_u8_s"] = time.perf_counter() - t0
    out["u8_checkpoint_of"] = "float32"

    # u8 cold start: codes cross the link, the kernel decodes them on the card
    st = ColdStartStats()
    dequant_u8.launches = 0
    got, _, _ = restore_pipelined(u8, model.param_tree(), device=dev, stats=st)
    launches = dequant_u8.launches
    plain, _, _ = load_checkpoint(u8, model.param_tree())  # host decode, plain version
    plain = flatten(plain, "param")
    for name, t in flatten(got, "param").items():
        if t.device != dev or not torch.equal(t.cpu(), plain[name]):
            raise SystemExit(f"chip_smoke: u8 leaf {name} differs from the plain decode")
    del got, plain
    if not launches == st.dequant_leaves == float_leaves:
        raise SystemExit(f"chip_smoke: {launches} dequant launches, {st.dequant_leaves} "
                         f"dequantized leaves, {float_leaves} float leaves")
    out["u8_cold_start"] = {**_cold(st), "dequant_launches": launches}

    # raw cold start through the serving entry point
    engine = ServeEngine(model, checkpoint=raw)
    if engine.device != dev:
        raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
    for name, t in flatten(model.param_tree(), "param").items():
        if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
            raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
    out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = flash_attention.tc_launches = decode_attention.launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    out["flash_attention_launches"] = flash_attention.launches
    out["flash_attention_tc_launches"] = flash_attention.tc_launches
    out["decode_attention_launches"] = decode_attention.launches
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    if (out["flash_attention_launches"], out["decode_attention_launches"]) != (
            cfg.n_layers, cfg.n_layers * max_new):
        raise SystemExit(f"chip_smoke: {out['flash_attention_launches']} flash and "
                         f"{out['decode_attention_launches']} decode launches, wanted "
                         f"{cfg.n_layers} and {cfg.n_layers * max_new}")
    if out["flash_attention_tc_launches"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {out['flash_attention_tc_launches']} of "
                         f"{out['flash_attention_launches']} flash launches went to the "
                         f"tensor-core kernel, wanted {cfg.n_layers}")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["long_prefill"] = _long_prefill(torch, engine, cfg)

    # the same requests with plain attention
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: first-step logits differ from plain attention: {out}")
    log(f"[serving] {json.dumps(out)}")
    out["tokens"] = tokens
    return out


def _long_prefill(torch, engine, cfg, S: int = 4096) -> dict:
    """One request with a 4,096-token prompt (numpy seed 1) and one new
    token: its prefill_s is where a long prompt's users see the flash
    kernel. Run twice; the second run, with the allocator warm, is the
    timed one (``long_prefill_s``), and must launch the tensor-core kernel
    once per layer."""
    import numpy as np

    from repro_torch.kernels import flash_attention

    prompt = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, (1, S)).astype(np.int32)
    out = {"prompt": S, "batch": 1}
    for key in ("long_prefill_first_s", "long_prefill_s"):
        engine.stats = {k: 0.0 for k in engine.stats}
        flash_attention.launches = flash_attention.tc_launches = 0
        engine.generate(prompt, max_new=1)
        out[key] = engine.stats["prefill_s"]
    out["flash_attention_launches"] = flash_attention.launches
    out["flash_attention_tc_launches"] = flash_attention.tc_launches
    if (flash_attention.launches, flash_attention.tc_launches) != (cfg.n_layers, cfg.n_layers):
        raise SystemExit(f"chip_smoke: long prefill launched {out}, wanted {cfg.n_layers} "
                         f"tensor-core flash launches")
    return out


# --------------------------------------------------------------- phase 6
@contextlib.contextmanager
def _plain_scan():
    """The serving path with ``ops.ssd_scan`` swapped for its plain version,
    for this script's comparison only."""
    from repro_torch.kernels import ops, ref

    kept = ops.ssd_scan

    def scan(x, dtA, Bm, Cm, *, chunk=128, return_state=False):
        y, state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=max(1, min(chunk, x.shape[2])))
        return (y, state) if return_state else y

    ops.ssd_scan = scan
    try:
        yield
    finally:
        ops.ssd_scan = kept


def phase_ssm_serving(torch) -> dict:
    """Mamba2-780M: raw checkpoint, cold start, and a batch of requests."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("mamba2_780m")
    B, S, max_new = 8, 512, 64
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "ssm_heads": cfg.n_ssm_heads, "headdim": cfg.ssm.headdim,
                 "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk, "dtype": cfg.param_dtype,
                 "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    ssd_scan.tc_launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    out["launches"] = launches
    out["ssd_scan_launches"] = launches["ssd_scan"]
    out["ssd_scan_tc_launches"] = ssd_scan.tc_launches
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    if launches != {"dequant_u8": 0, "flash_attention": 0, "decode_attention": 0,
                    "ssd_scan": cfg.n_layers}:
        raise SystemExit(f"chip_smoke: Mamba2 generate launched {launches}, wanted "
                         f"{cfg.n_layers} ssd_scan and nothing else")
    if out["ssd_scan_tc_launches"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {out['ssd_scan_tc_launches']} of {cfg.n_layers} "
                         f"ssd_scan launches ran the tensor-core kernels")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()

    # the same requests with the plain scan
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_scan():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: first-step logits differ from the plain scan: {out}")

    # where the bf16 difference comes from: the two scans differ by the order of
    # their f32 sums, which flips some bf16 roundings of y; the layers carry the
    # flips on. The hidden state's relative difference layer by layer, and the
    # same first-step comparison with the model in f32 (no bf16 rounding)
    tokens_dev = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    out["hidden_rel_diff_by_layer"] = _hidden_divergence(torch, model, tokens_dev)
    del engine, model
    f32_model = build_model(cfg.with_(param_dtype="float32", compute_dtype="float32"),
                            device=dev, seed=SEED)
    first32, _ = f32_model.prefill(tokens_dev)
    with _plain_scan():
        plain32, _ = f32_model.prefill(tokens_dev)
    out["f32_first_logits_max_abs_diff"] = float((first32 - plain32).abs().max())
    out["f32_first_logits_max_abs"] = float(plain32.abs().max())
    del f32_model
    log(f"[ssm serving] {json.dumps(out)}")
    return out


def _hidden_divergence(torch, model, tokens) -> dict:
    """Relative difference ||h_kernel - h_plain|| / ||h_plain|| of the hidden
    state after layers 1, 6, 12, 24 and 48, each path running its own scan
    from the same embeddings."""
    from repro_torch.models.common import make_norm
    from repro_torch.models.mamba import mamba_forward

    cfg = model.cfg
    _, norm = make_norm(cfg.norm)
    out = {}
    with torch.inference_mode():
        xk = xp = model._embed_inputs(tokens)
        for i, p in enumerate(model._layer_params()):
            xk = xk + mamba_forward(p["ssm"], norm(p["ln"], xk), cfg)
            with _plain_scan():
                xp = xp + mamba_forward(p["ssm"], norm(p["ln"], xp), cfg)
            if i + 1 in (1, 6, 12, 24, cfg.n_layers):
                out[str(i + 1)] = float((xk.float() - xp.float()).norm() / xp.float().norm())
    return out


# --------------------------------------------------------------- phase 7
GEMMA3_LAYERS = 12  # of 48: two periods of the 5 local : 1 global pattern


def phase_gemma3_serving(torch) -> dict:
    """gemma3-12b at full widths and 12 layers: raw checkpoint, cold start,
    and a batch of requests whose prompts are longer than the local window."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    published = get_config("gemma3_12b")
    cfg = published.with_(n_layers=GEMMA3_LAYERS)
    B, S, max_new = 4, 2048, 32
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": published.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "sliding_window": cfg.sliding_window, "global_every": cfg.global_every,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    _temper_attention(torch, model)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gemma3_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED + 2).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(kernels)
    tokens = engine.generate(prompts, max_new=max_new)
    launches = _counts(kernels)
    out["launches"] = launches
    out["flash_attention_launches"] = launches["flash_attention"]
    out["flash_attention_tc_launches"] = launches["flash_attention_tc"]
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * max_new, "ssd_scan": 0,
            "flash_attention_tc": cfg.n_layers}  # all flash launches on the tensor cores
    if launches != want:
        raise SystemExit(f"chip_smoke: gemma3 generate launched {launches}, wanted {want}")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["decode_events_per_step"] = _decode_events(torch, engine, prompts, S + max_new)

    # the same requests with plain attention
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: gemma3 first-step logits differ from plain attention: "
                         f"{out}")
    log(f"[gemma3 serving] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 8
PAPER_LM_STEPS, PAPER_LM_RESUME_AT = 60, 40


@contextlib.contextmanager
def _tee_stdout():
    """Print as usual and also keep what is printed (the CLI's resume line)."""
    import io

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        yield buf


def _counts(kernels) -> dict:
    """Each kernel module's launch count, and the flash tensor-core ones."""
    from repro_torch.kernels import flash_attention

    out = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    out["flash_attention_tc"] = flash_attention.tc_launches
    return out


def _reset_counts(kernels) -> None:
    from repro_torch.kernels import flash_attention

    for k in kernels:
        k.launches = 0
    flash_attention.tc_launches = 0


def _reset_flash_counts() -> None:
    from repro_torch.kernels import flash_attention

    flash_attention.launches = flash_attention.tc_launches = flash_attention.bwd_launches = 0


def _flash_counts() -> dict:
    from repro_torch.kernels import flash_attention

    return {"forward": flash_attention.launches, "backward": flash_attention.bwd_launches}


def _train_row(out: dict, layers: int, remat: bool) -> dict:
    st = out["loader_stats"]
    steps = len(out["losses"])
    row = {"steps": steps, "first_loss": out["losses"][0], "last_loss": out["losses"][-1],
           "wall_s": out["wall_s"], "steps_per_s": steps / out["wall_s"],
           "median_step_s": statistics.median(out["step_s"]),
           "device_wait_s": st.get("device_wait_s"),
           "h2d_gb_per_s": (st["h2d_bytes"] / st["h2d_s"] / 1e9) if st.get("h2d_s") else None,
           "h2d_bytes": st.get("h2d_bytes"), "ckpt_save_s": out["ckpt_save_s"],
           "stragglers": out["stragglers"]}
    if out["cold_start"] is not None:
        row["cold_start"] = _cold(out["cold_start"])
    row["want_launches"] = {"forward": layers * steps * (2 if remat else 1),
                            "backward": layers * steps}
    return row


def phase_paper_lm_training(torch) -> dict:
    """paper_lm through the CLI: straight, then stopped and resumed; then
    served from the trained checkpoint."""
    import numpy as np

    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, RaDataset
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.launch.train import parse_args, run
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("paper_lm")
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab, "dtype": cfg.param_dtype, "batch": 8, "seq": 256}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        straight, stopped = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")
        ds = os.path.join(straight, "dataset")  # the CLI builds it on its first run

        def cli(workdir, steps, *extra):
            args = ["--arch", "paper_lm", "--device-feed", "--batch", "8", "--steps",
                    str(steps), "--ckpt-every", "20", "--seed", str(SEED), "--workdir",
                    workdir, *extra]
            _reset_flash_counts()
            with _tee_stdout() as text:
                res = run(parse_args(args))
            torch.cuda.synchronize()
            return res, text.getvalue(), _flash_counts()

        runs = {}
        for name, workdir, steps, extra in (
                ("straight", straight, PAPER_LM_STEPS, ()),
                ("first", stopped, PAPER_LM_RESUME_AT, ("--dataset", ds)),
                ("resumed", stopped, PAPER_LM_STEPS, ("--dataset", ds))):
            res, text, launches = cli(workdir, steps, *extra)
            row = _train_row(res, cfg.n_layers, cfg.remat)
            row["launches"] = launches
            if launches != row["want_launches"]:
                raise SystemExit(f"chip_smoke: paper_lm {name} run launched {launches}, "
                                 f"wanted {row['want_launches']}")
            if name == "resumed":
                row["printed_resume"] = f"[train] resumed from step {PAPER_LM_RESUME_AT}" in text
                if not row["printed_resume"]:
                    raise SystemExit("chip_smoke: the resumed run did not print "
                                     f"'[train] resumed from step {PAPER_LM_RESUME_AT}'")
            runs[name] = (row, flatten(res["params"], "param"))
        row_a, params_a = runs["straight"]
        _, params_b = runs["resumed"]
        losses_ok = row_a["last_loss"] < row_a["first_loss"]
        out["runs"] = {name: row for name, (row, _) in runs.items()}
        out["loss_falls"] = losses_ok
        out["params_bit_equal"] = all(bool(torch.equal(params_a[n], params_b[n]))
                                      for n in params_a)
        out["params_max_abs_diff"] = max(float((params_a[n] - params_b[n]).abs().max())
                                         for n in params_a)
        close = all(bool(torch.allclose(params_b[n], params_a[n], rtol=1e-5, atol=1e-6))
                    for n in params_a)
        if not losses_ok or not close:
            raise SystemExit(f"chip_smoke: paper_lm training: loss falls {losses_ok}, "
                             f"straight and resumed parameters close {close}: {out}")
        del runs, params_a, params_b

        # serve the trained checkpoint: greedy tokens equal plain attention's
        ckpt = os.path.join(stopped, "ckpt", f"step_{PAPER_LM_STEPS:08d}")
        engine = ServeEngine(build_model(cfg, device=dev, seed=SEED + 1), checkpoint=ckpt)
        prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (2, 64)).astype(np.int32)
        tokens = engine.generate(prompts, max_new=16)
        with _plain_attention():
            plain = engine.generate(prompts, max_new=16)
        out["serve"] = {"checkpoint_step": PAPER_LM_STEPS, "cold_start": _cold(engine.cold_start),
                        "tokens_equal_plain": bool((tokens == plain).all())}
        if not out["serve"]["tokens_equal_plain"]:
            raise SystemExit(f"chip_smoke: tokens served from the trained checkpoint differ "
                             f"from plain attention's: {tokens} vs {plain}")
        host = DataLoader(RaDataset(ds), 8, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["profiled_step"] = _profiled_step(
            torch, build_model(cfg, device=dev, seed=SEED).requires_grad_(True),
            AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200), batch)
    log(f"[paper_lm training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 9
INTERNLM2_TRAIN_STEPS = 6
INTERNLM2_PARAMS = 1_889_110_016
#: the attention projections whose gradients phase 9 holds to plain attention's
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
#: MLA's (phase 21): every projection the attention's q, k and v gradients reach
MLA_LEAVES = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")
#: the largest ||kernel grad − plain grad|| / ||plain grad|| of one layer's
#: attention projection in phase 9's and phase 10's first steps. On an H100
#: (700 W) InternLM2's sound step reads 0.0346 (wk; bf16 rounding carried
#: through 24 layers), its planted faults 0.106 (dq 10% too large) and 1.0 (dk
#: zeroed); gemma3's (12 layers, head width 256) 0.0123, 0.102 and 1.0: PERF.md §6
ATTN_GRAD_TOL = 0.05
#: the leaves of each Mamba2 layer that phases 22-23's first-step gate holds to the
#: plain scan backward's, and their tolerance: ATTN_GRAD_TOL's rule (the largest
#: relative error of one layer's gradient)
SSM_LEAVES = ("w_x", "w_B", "w_C", "w_dt", "A_log", "dt_bias", "D")
SSM_GRAD_TOL = 0.05


@functools.lru_cache(maxsize=None)
def _kernel_names(source: str) -> tuple:
    """The ``__global__`` functions a CUDA source of the port defines."""
    from repro_torch.kernels import _build

    text = (Path(_build.CSRC) / source).read_text()
    found = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    if not found:
        raise SystemExit(f"chip_smoke: no __global__ function found in {source}")
    return tuple(sorted(set(found)))


def _kernel_kind(name: str) -> str:
    """The kind of a device event of a train step, by the kernel's name: the
    attention kernels by the ``__global__`` functions of their sources, so a
    renamed kernel is still counted as what it is."""
    for source, kind in (("flash_attention_bwd.cu", "attention backward"),
                         ("flash_attention.cu", "attention forward"),
                         ("ssd_scan_bwd.cu", "scan backward"),
                         ("ssd_scan.cu", "scan forward")):
        if any(k in name for k in _kernel_names(source)):  # demangled or mangled
            return kind
    if any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def _profiled_step(torch, model, adamw, batch,
                   require=("attention forward", "attention backward")) -> dict:
    """One more train step under the profiler (after the checks: it moves the
    weights), in two traces: the forward and backward, then the optimizer.
    For each, its wall time, the summed device time of its kernels by kind,
    and the share of the wall time the card had no kernel running. The
    forward and backward must show a kernel of each kind in ``require``."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import optimizer as optim

    params = model.param_tree()
    state = optim.init_state(params, adamw)

    def forward_backward():
        loss, _ = model.train_loss(batch)
        loss.backward()

    def update():
        optim.apply_updates(params, optim.tree_map(lambda p: p.grad, params), state, adamw)
        for p in optim.leaves(params):
            p.grad = None

    forward_backward()  # warm: the moments and the allocator
    update()
    torch.cuda.synchronize()
    out = {}
    for name, fn in (("forward_backward", forward_backward), ("optimizer", update)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_kind[_kernel_kind(evt.name)] += evt.time_range.elapsed_us() / 1e3
        device_ms = sum(by_kind.values())
        out[name] = {"wall_ms": wall_ms, "device_ms": device_ms,
                     "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
                     "device_ms_by_kind": dict(by_kind)}
    kinds = out["forward_backward"]["device_ms_by_kind"]
    if not all(kinds.get(kind) for kind in require):
        raise SystemExit(f"chip_smoke: the profiled step shows no kernel of some kind of "
                         f"{require} by name: {kinds}")
    del state
    return out


def _attention_trees(params) -> dict:
    """The attention subtrees of a params tree, by a prefix for their leaves'
    names, each with whether it is stacked over layers: the dense and vlm
    families' one (no prefix); the moe family's two stacks and DeepSeek-V3's
    MTP layer (one layer, not stacked); whisper's three (the encoder's, the
    decoder's self- and cross-attention)."""
    if "enc_layers" in params:
        return {"enc.attn.": (params["enc_layers"]["attn"], True),
                "dec.self_attn.": (params["dec_layers"]["self_attn"], True),
                "dec.cross_attn.": (params["dec_layers"]["cross_attn"], True)}
    if "moe_layers" not in params:
        return {"": (params["dense_layers"]["attn"], True)}
    trees = {f"{group}.": (params[f"{group}_layers"]["attn"], True)
             for group in ("dense", "moe") if f"{group}_layers" in params}
    if "mtp" in params:
        trees["mtp."] = (params["mtp"]["layer"]["attn"], False)
    return trees


def _attention_leaves(params) -> dict:
    """The attention projections a first-step gate holds: ``ATTN_LEAVES`` of
    each attention subtree, MLA's ``MLA_LEAVES``; name -> (parameter,
    stacked over the layers)."""
    return {prefix + n: (attn[n], stacked)
            for prefix, (attn, stacked) in _attention_trees(params).items()
            for n in (MLA_LEAVES if "wkv_b" in attn else ATTN_LEAVES)}


def _ssm_leaves(params) -> dict:
    """The Mamba2 layers' leaves the scan's gradients reach first
    (``SSM_LEAVES``), stacked over the layers."""
    return {n: (params["layers"]["ssm"][n], True) for n in SSM_LEAVES}


def _first_step(torch, model, batch, select=_attention_leaves) -> tuple:
    """Loss, global gradient norm and a copy of the gradients of the leaves
    ``select`` picks (stacked over the layers; an unstacked one as a stack of
    one) of one forward and backward; the model's gradients are freed."""
    from repro_torch.distributed import optimizer as optim

    loss, _ = model.train_loss(batch)
    loss.backward()
    params = model.param_tree()
    norm = float(optim.global_norm(optim.tree_map(lambda p: p.grad, params)))
    grads = {}
    for name, (p, stacked) in select(params).items():
        g = p.grad.clone()
        grads[name] = g if stacked else g[None]
    for p in optim.leaves(params):
        p.grad = None
    return float(loss.detach()), norm, grads


def _attention_grad_err(torch, got: dict, want: dict) -> dict:
    """For each attention projection, over the layers: the largest
    ||got − want|| / ||want|| of a layer's gradient ("err"), and the largest
    relative difference of a layer's gradient norm ("norm")."""
    out = {}
    for n in want:
        g = got[n].float().flatten(1)
        w = want[n].float().flatten(1)
        ref_norm = w.norm(dim=1)
        out[n] = {"err": float(((g - w).norm(dim=1) / ref_norm).max()),
                  "norm": float(((g.norm(dim=1) - ref_norm).abs() / ref_norm).max())}
    return out


@contextlib.contextmanager
def _planted_backward_fault(which: str):
    """The backward kernel with a planted fault in one of its outputs (dk
    zeroed, or dq 10% too large), for the control of phase 9's gradient gate."""
    from repro_torch.kernels import flash_attention as fa

    kept = fa.flash_attention_bwd

    def faulty(*args, **kwargs):
        dq, dk, dv = kept(*args, **kwargs)
        if which == "dk_zeroed":
            return dq, dk.zero_(), dv
        return dq.mul_(1.1), dk, dv

    fa.flash_attention_bwd = faulty
    try:
        yield
    finally:
        fa.flash_attention_bwd = kept


@contextlib.contextmanager
def _plain_backward(heads=None):
    """The attention's backward kernel swapped for its plain version (f32, D
    from the forward's f32 output; with ``heads``, that many q heads a call),
    the forward kernel kept."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    kept = fa.flash_attention_bwd

    def plain(q, k, v, out, dout, lse, *, causal=True, window=0, scale=None):
        return _plain_bwd(torch, q, k, v, out.float(), dout, lse, causal, window, heads,
                          scale=scale)

    fa.flash_attention_bwd = plain
    try:
        yield
    finally:
        fa.flash_attention_bwd = kept


@contextlib.contextmanager
def _f64_attention(torch, heads=None):
    """The attention op computed in float64 (rounded once to the inputs'
    dtype) and differentiated by autograd: a plain attention of another
    precision, for the control of ``_first_step_gates``; with ``heads``,
    that many q heads at a time (``_by_heads``)."""
    from repro_torch.kernels import ops, ref

    kept = ops.flash_attention

    def flash(q, k, v, *, causal=True, window=0, **_):
        def fn(q, k, v):
            g = q.shape[1] // k.shape[1]
            kd = k.double().repeat_interleave(g, dim=1)
            vd = v.double().repeat_interleave(g, dim=1)
            s = torch.matmul(q.double(), kd.transpose(-1, -2)) * q.shape[-1] ** -0.5
            ok = ref._live(q.shape[2], k.shape[2], causal, window, q.device)
            p = s.masked_fill(~ok, float("-inf")).softmax(dim=-1)
            return torch.matmul(p, vd).to(q.dtype)

        return fn(q, k, v) if heads is None else _by_heads(torch, fn, heads, q, k, v)

    ops.flash_attention = flash
    try:
        yield
    finally:
        ops.flash_attention = kept


@contextlib.contextmanager
def _plain_scan_backward():
    """The scan's backward kernel swapped for its plain version
    (``ref.ssd_scan_bwd_ref`` on the card), the forward kernel kept."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    kept = ssd.ssd_scan_bwd
    ssd.ssd_scan_bwd = lambda *args, **kw: ref.ssd_scan_bwd_ref(*args, **kw)
    try:
        yield
    finally:
        ssd.ssd_scan_bwd = kept


@contextlib.contextmanager
def _planted_scan_fault(which: str):
    """The scan's backward kernel with a planted fault in its output, for the
    control of the scan's gradient gate: dB summed over one head only (the
    kernel run again on head 0 alone), or d(dtA) 10% too large."""
    from repro_torch.kernels import ssd_scan as ssd

    kept = ssd.ssd_scan_bwd

    def faulty(x, dtA, Bm, Cm, dy, *, chunk):
        dx, da, dB, dC = kept(x, dtA, Bm, Cm, dy, chunk=chunk)
        if which == "dB_one_head":
            one = (t[:, :1].contiguous() for t in (x, dtA))
            dB = kept(*one, Bm, Cm, dy[:, :1].contiguous(), chunk=chunk)[2]
            return dx, da, dB, dC
        return dx, da.mul_(1.1), dB, dC

    ssd.ssd_scan_bwd = faulty
    try:
        yield
    finally:
        ssd.ssd_scan_bwd = kept


def _first_step_gates(torch, model, batch, name: str, out: dict,
                      reference: str = "plain attention", heads=None) -> dict:
    """The first train step of ``model`` on ``batch`` against the same step
    with plain attention: the loss within 1%, the global gradient norm within
    2%, each layer's wq/wk/wv/wo gradient (of each attention kind) within
    ``ATTN_GRAD_TOL``; then the same step with each planted backward fault,
    which must break the last gate. Fails the run on any miss; returns the
    readings.

    With ``reference="plain backward"`` the gradient gate (and its planted
    faults) compares against the same forward kernel with the plain backward,
    so it holds the backward kernel alone; the gradients against plain
    attention are read, beside a control: plain attention in f32 against
    plain attention in f64, the spread that 1-ulp differences in the
    forward's bf16 outputs reach in this model's gradients. whisper and llava
    take it: there that spread reaches or passes the tolerance with no kernel
    in the path (PERF.md §6). With ``heads`` every plain attention runs
    that many q heads a call (the moe family's scores would be 8.6 and 17 GB
    a tensor whole).

    With ``reference="plain scan backward"`` (the ssm and hybrid families)
    every gate compares against the same forward kernels with the scan's
    backward kernel swapped for its plain version, the leaves gated are the
    Mamba2 layers' ``SSM_LEAVES`` (within ``SSM_GRAD_TOL``), and the planted
    faults are the scan backward's (dB from one head, d(dtA) 10% too large)."""
    scan = reference == "plain scan backward"
    what = "scan" if scan else "attention"
    select = _ssm_leaves if scan else _attention_leaves
    tol = SSM_GRAD_TOL if scan else ATTN_GRAD_TOL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, norm_k, grads_k = _first_step(torch, model, batch, select)
    out["first_step_s_kernels"] = time.perf_counter() - t0
    with _plain_scan_backward() if scan else _plain_attention(heads):
        loss_p, norm_p, grads_p = _first_step(torch, model, batch, select)
    grad_err = _attention_grad_err(torch, grads_k, grads_p)
    first = {"loss": loss_k, "plain_loss": loss_p, "grad_norm": norm_k,
             "plain_grad_norm": norm_p,
             "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
             "grad_norm_rel_diff": abs(norm_k - norm_p) / norm_p,
             "gradient_reference": reference}
    if reference == "plain backward":
        first["attention_grads_vs_plain_attention"] = grad_err
        first["attention_grad_err_vs_plain_attention"] = max(
            e["err"] for e in grad_err.values())
        with _f64_attention(torch, heads):
            _, _, grads_64 = _first_step(torch, model, batch)
        floor = _attention_grad_err(torch, grads_64, grads_p)
        first["control_f32_vs_f64_plain_attention"] = max(e["err"] for e in floor.values())
        del grads_64
        with _plain_backward(heads):
            _, _, grads_p = _first_step(torch, model, batch)
        grad_err = _attention_grad_err(torch, grads_k, grads_p)
    first.update({f"{what}_grads": grad_err,
                  f"{what}_grad_err": max(e["err"] for e in grad_err.values()),
                  f"{what}_grad_tolerance": tol})
    del grads_k
    # the control: the same step with a fault planted in the backward's
    # output must fail the gradient gate
    faults = (("dB_one_head", "ddtA_times_1.1") if scan else ("dk_zeroed", "dq_times_1.1"))
    first["planted_faults"] = {}
    for fault in faults:
        with _planted_scan_fault(fault) if scan else _planted_backward_fault(fault):
            _, _, grads_f = _first_step(torch, model, batch, select)
        err = _attention_grad_err(torch, grads_f, grads_p)
        first["planted_faults"][fault] = {
            f"{what}_grads": err,
            f"{what}_grad_err": max(e["err"] for e in err.values())}
        del grads_f
    del grads_p
    log(f"[{name} training] first step {json.dumps(first)}")
    caught = all(f[f"{what}_grad_err"] > tol for f in first["planted_faults"].values())
    if not (first["loss_rel_diff"] <= 0.01 and first["grad_norm_rel_diff"] <= 0.02
            and first[f"{what}_grad_err"] <= tol):
        raise SystemExit(f"chip_smoke: {name}'s first step differs from {reference}'s: "
                         f"{first}")
    if not caught:
        raise SystemExit(f"chip_smoke: the {what}-gradient gate let a planted "
                         f"backward fault through ({name}): {first['planted_faults']}")
    return first


def phase_internlm2_training(torch) -> dict:
    """InternLM2-1.8B at full size: 6 train steps, a checkpoint, its restore."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import ColdStartStats, restore_pipelined
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.train import TrainLoopConfig, train

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S = 4, 2048
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
                 "remat": cfg.remat, "batch": B, "seq": S, "steps": INTERNLM2_TRAIN_STEPS}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_internlm2_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=64, seq_len=S, vocab=cfg.vocab, seed=3, shard_rows=64)

        # the first step against plain attention: same weights, same batch
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["first_step"] = _first_step_gates(torch, model, batch, "InternLM2", out)
        torch.cuda.empty_cache()

        ckpt_dir = os.path.join(tmp, "ckpt")
        out["disk_free_bytes_before_save"] = shutil.disk_usage(tmp).free
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        res = train(model, feed, TrainLoopConfig(
            steps=INTERNLM2_TRAIN_STEPS, ckpt_every=INTERNLM2_TRAIN_STEPS, ckpt_dir=ckpt_dir,
            log_every=1, adamw=AdamWConfig(lr=1e-3, warmup_steps=2)), resume=False)
        torch.cuda.synchronize()
        launches = _flash_counts()
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        row = _train_row(res, cfg.n_layers, cfg.remat)
        row["launches"] = launches
        row["losses"] = res["losses"]
        row["step_s"] = res["step_s"]
        step_s = statistics.median(res["step_s"][1:])
        row["tokens_per_s"] = B * S / step_s
        row["model_tflops_per_s"] = 6 * INTERNLM2_PARAMS * B * S / step_s / 1e12
        out["train"] = row
        finite = all(np.isfinite(res["losses"]))
        if not finite or res["losses"][-1] >= res["losses"][0]:
            raise SystemExit(f"chip_smoke: InternLM2 training: losses {res['losses']}")
        if launches != row["want_launches"]:
            raise SystemExit(f"chip_smoke: InternLM2 training launched {launches}, wanted "
                             f"{row['want_launches']}")

        # the checkpoint at the last step: params and optimizer state, restored
        # by the cold start, every leaf bit-equal to the live state it saved
        path = os.path.join(ckpt_dir, f"step_{INTERNLM2_TRAIN_STEPS:08d}")
        saved_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        params, opt_state = res["params"], res["opt_state"]
        for p in model.parameters():
            p.grad = None
        del res
        torch.cuda.empty_cache()
        st = ColdStartStats()
        got_p, got_o, extra = restore_pipelined(path, params, opt_state, device=dev, stats=st)
        live = {**flatten(params, "param"), **flatten(opt_state, "opt")}
        restored = {**flatten(got_p, "param"), **flatten(got_o, "opt")}
        equal = set(live) == set(restored) and all(
            bool(torch.equal(restored[n], live[n])) for n in live)
        out["checkpoint"] = {"bytes": saved_bytes, "leaves": len(restored),
                             "save_s": row["ckpt_save_s"],
                             "save_gb_per_s": saved_bytes / row["ckpt_save_s"] / 1e9,
                             "restore": _cold(st), "restore_bit_equal": equal,
                             "extra_keys": sorted(extra)}
        del got_p, got_o, restored, live, opt_state
        if not equal:
            raise SystemExit("chip_smoke: the InternLM2 train checkpoint did not restore "
                             "bit-equal")
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, AdamWConfig(lr=1e-3, warmup_steps=2),
                                          batch)
    del model, params
    torch.cuda.empty_cache()
    log(f"[internlm2 training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 10
GEMMA3_TRAIN_STEPS = 4


def phase_gemma3_training(torch) -> dict:
    """gemma3-12b at full widths and 12 of 48 layers: the first step against
    plain attention (head width 256, local and global layers), then 4 steps
    of the train loop's step; no checkpoint (phases 8 and 9 hold that path)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed import optimizer as optim
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step

    dev = torch.device("cuda", 0)
    published = get_config("gemma3_12b")
    cfg = published.with_(n_layers=GEMMA3_LAYERS)
    B, S, steps = 2, 2048, GEMMA3_TRAIN_STEPS
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": published.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "sliding_window": cfg.sliding_window, "global_every": cfg.global_every,
                 "dtype": cfg.param_dtype, "remat": cfg.remat, "batch": B, "seq": S,
                 "steps": steps}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gemma3_train_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=16, seq_len=S, vocab=cfg.vocab, seed=4, shard_rows=16)
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["first_step"] = _first_step_gates(torch, model, batch, "gemma3", out)
        torch.cuda.empty_cache()

        # the steps train() runs (its make_step) on DeviceLoader batches; train()
        # itself saves a checkpoint at its end, here 37 GB of parameters and moments
        adamw = AdamWConfig(lr=1e-3, warmup_steps=2)
        params = model.param_tree()
        state = optim.init_state(params, adamw)
        step_fn = make_step(model, adamw)
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        losses, step_s = [], []
        try:
            for _ in range(steps):
                feed_batch = next(feed)
                feed_batch.pop("_state", None)
                t0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, feed_batch)
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t0)
        finally:
            feed.stop()
        torch.cuda.synchronize()
    launches = _flash_counts()
    step = statistics.median(step_s[1:])
    row = {"steps": steps, "losses": losses, "step_s": step_s, "median_step_s": step,
           "tokens_per_s": B * S / step,
           "model_tflops_per_s": 6 * out["params"] * B * S / step / 1e12,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev), "launches": launches,
           "want_launches": {"forward": cfg.n_layers * steps * (2 if cfg.remat else 1),
                             "backward": cfg.n_layers * steps}}
    out["train"] = row
    log(f"[gemma3 training] steps {json.dumps(row)}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"chip_smoke: gemma3 training: losses {losses}")
    if launches != row["want_launches"]:
        raise SystemExit(f"chip_smoke: gemma3 training launched {launches}, wanted "
                         f"{row['want_launches']}")
    del state, params
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch)
    del model
    torch.cuda.empty_cache()
    log(f"[gemma3 training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 11
#: prefill vs replay of the f32 copy: tests/test_models.py:63-78's tolerance,
#: atol of the logits' scale
F32_REPLAY_TOL = (2e-3, 2e-4)


def _first_logits_gate(torch, out: dict, key: str, got, plain, what: str) -> None:
    """Record ``got`` against ``plain`` under ``key`` and fail beyond
    ``LOGITS_TOL`` of the plain logits' scale."""
    import numpy as np

    scale = float(plain.abs().max())
    diff = float((got - plain).abs().max())
    out[key] = {"max_abs_diff": diff, "max_abs": scale, "tolerance": LOGITS_TOL * scale}
    if not np.isfinite(diff) or diff > LOGITS_TOL * scale:
        raise SystemExit(f"chip_smoke: {what} differ from the plain versions': {out}")


def _profiled_steps(torch, model, prompts, capacity: int, n: int = 8) -> dict:
    """Wall and device time of ``n`` decode steps under the profiler, fed
    as the engine's replay feeds them (the prompt's tokens) and as its decode
    loop does (the argmax of the last logits), on one cache; both traced
    twice, the second pass kept. Per step: wall ms, device ms (the summed
    kernel durations) and the share of the wall time the card had no kernel
    running."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(prompts[:, :n].astype("int64")).to(model.device)
    cache = model.empty_cache(tokens.shape[0], capacity)  # room for 4n + 1 steps
    logits, cache = model.decode_step(cache, tokens[:, :1])
    out = {}
    feeds = (("replay", lambda i, _: tokens[:, i:i + 1]),
             ("decode", lambda i, lg: lg.argmax(-1, keepdim=True)))
    for name, feed in feeds + feeds:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                logits, cache = model.decode_step(cache, feed(i, logits))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out[name] = {"steps": n, "wall_ms_per_step": wall_ms / n,
                     "device_ms_per_step": device_ms / n,
                     "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    return out


def phase_zamba2_serving(torch) -> dict:
    """Zamba2-1.2B at its full size: raw checkpoint, cold start, a batch of
    requests served through the engine's prompt replay, then the model's
    chunked prefill and an f32 copy's prefill against its replay."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("zamba2_1_2b")
    B, S, max_new = 8, 256, 32
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    n_inv = len(model.invocations)
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "invocations": n_inv, "shared_heads": cfg.n_heads,
                 "shared_kv_heads": cfg.n_kv_heads, "shared_head_dim": model.attn_cfg.head_dim,
                 "d_ff": cfg.d_ff, "ssm_heads": cfg.n_ssm_heads, "headdim": cfg.ssm.headdim,
                 "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk, "vocab": cfg.vocab,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new,
                 "init_s": time.perf_counter() - t0}
    _temper_attention(torch, model)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zamba2_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    # the main generate: the prompt replayed through decode_step, then 31 steps
    prompts = np.random.default_rng(SEED + 3).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(kernels)
    with _first_logits(engine) as first:
        tokens = engine.generate(prompts, max_new=max_new)
    launches = _counts(kernels)
    out["launches"] = launches
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": 0,
            "decode_attention": n_inv * (S + max_new - 1), "ssd_scan": 0,
            "flash_attention_tc": 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: Zamba2 generate launched {launches}, wanted {want}")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["warm"]["ms_per_replayed_token"] = out["warm"]["prefill_s"] / S * 1e3
    out["warm"]["ms_per_decode_step"] = out["warm"]["decode_s"] / (max_new - 1) * 1e3
    out["profiled_steps"] = _profiled_steps(torch, model, prompts, S + max_new)

    # the same requests with both attention ops and the scan plain; each run's
    # first-step logits kept from its generate (a replay takes 10-20 s)
    with _plain_attention(), _plain_scan(), _first_logits(engine) as plain_first:
        plain_tokens = engine.generate(prompts, max_new=max_new)
    first, plain_first = first[0], plain_first[0]
    _first_logits_gate(torch, out, "first_logits", first, plain_first,
                       "Zamba2 first-step logits")
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())

    # the chunked prefill: 6 flash and 38 ssd_scan launches, all on the tensor cores
    tokens_dev = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    for k in (flash_attention, ssd_scan):
        k.launches = k.tc_launches = 0
    prefill_logits = model.prefill(tokens_dev)[0].float()
    torch.cuda.synchronize()
    pf = {"flash_attention": flash_attention.launches,
          "flash_attention_tc": flash_attention.tc_launches,
          "ssd_scan": ssd_scan.launches, "ssd_scan_tc": ssd_scan.tc_launches}
    out["prefill_launches"] = pf
    want = {"flash_attention": n_inv, "flash_attention_tc": n_inv,
            "ssd_scan": cfg.n_layers, "ssd_scan_tc": cfg.n_layers}
    if pf != want:
        raise SystemExit(f"chip_smoke: Zamba2 prefill launched {pf}, wanted {want}")
    t0 = time.perf_counter()
    model.prefill(tokens_dev)
    torch.cuda.synchronize()
    out["model_prefill_s"] = time.perf_counter() - t0  # warm: the chunked path's time
    with _plain_attention(), _plain_scan():
        plain_prefill = model.prefill(tokens_dev)[0].float()
    _first_logits_gate(torch, out, "prefill_logits", prefill_logits, plain_prefill,
                       "Zamba2 prefill logits")
    out["prefill_vs_replay_bf16"] = {
        "max_abs_diff": float((prefill_logits - first).abs().max()),
        "max_abs": float(first.abs().max()),
        "argmax_agreement": float((prefill_logits.argmax(-1) == first.argmax(-1))
                                  .float().mean())}

    # an f32 copy of the weights: its chunked prefill against its replay
    f32 = build_model(cfg.with_(param_dtype="float32", compute_dtype="float32"), device="meta")
    load_params(f32, _float32(torch, model.param_tree()))
    del engine, model
    torch.cuda.empty_cache()
    pf32 = f32.prefill(tokens_dev)[0]
    replay32 = ServeEngine(f32)._prefill_with_capacity(prompts, S)[0]
    rtol, atol = F32_REPLAY_TOL
    scale = float(replay32.abs().max())
    out["f32_prefill_vs_replay"] = {
        "max_abs_diff": float((pf32 - replay32).abs().max()), "max_abs": scale,
        "rtol": rtol, "atol": atol * scale,
        "argmax_agreement": float((pf32.argmax(-1) == replay32.argmax(-1)).float().mean())}
    ok = bool(torch.allclose(pf32, replay32, rtol=rtol, atol=atol * scale))
    del f32, pf32, replay32
    torch.cuda.empty_cache()
    log(f"[zamba2 serving] {json.dumps(out)}")
    if not ok:
        raise SystemExit(f"chip_smoke: Zamba2's f32 prefill and replay differ: "
                         f"{out['f32_prefill_vs_replay']}")
    return out


@contextlib.contextmanager
def _first_logits(engine):
    """Keep, in the list it yields, the float32 first-step logits of each
    prompt prefill ``engine.generate`` runs inside the block."""
    kept, got = engine._prefill_with_capacity, []

    def prefill(prompts, capacity):
        logits, cache = kept(prompts, capacity)
        got.append(logits.float())
        return logits, cache

    engine._prefill_with_capacity = prefill
    try:
        yield got
    finally:
        del engine._prefill_with_capacity  # the class's method again


def _decode_events(torch, engine, prompts, capacity: int, attempts: int = 3) -> int:
    """Device events of ``decode_attention`` in one traced decode step: one a
    layer, the kernel and nothing else (no fold kernel, no copy of pos). A
    trace that shows another count is taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention

    logits, cache = engine._prefill_with_capacity(prompts, capacity)
    step = logits.argmax(-1, keepdim=True)
    layers = engine.cfg.n_layers
    for _ in range(attempts):
        torch.cuda.synchronize()
        before = decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = engine.model.decode_step(cache, step)
            torch.cuda.synchronize()
        cache["pos"] = cache["pos"] - 1  # the same step again on the next attempt
        events = sum("decode_attention" in e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if events == decode_attention.launches - before == layers:
            return events
        log(f"[gemma3 serving] a traced decode step showed {events} decode events for "
            f"{decode_attention.launches - before} launches, wanted {layers}")
    raise SystemExit(f"chip_smoke: {attempts} traced decode steps did not show one "
                     f"decode_attention event a layer")


# --------------------------------------------------------------- phase 12
#: the bearer token of phase 12's origin, which takes uploads with it
REMOTE_TOKEN = "chip-smoke-upload"
#: RAM cache of each edge in phase 12's fleet: a third of the raw InternLM2
#: checkpoint (3.78 GB over 3 edges) with room for the hash's imbalance, so
#: the warm pass is served by the edges alone
EDGE_CACHE_BYTES = 2 << 30


@contextlib.contextmanager
def _origin(root: str):
    """The port's byte-range server over ``root``, as a subprocess (its
    threads off this process's GIL), taking uploads with ``REMOTE_TOKEN``.
    Yields its URL, parsed from the line it prints; stopped on exit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote.server", root, "--port", "0",
         "--upload-token", REMOTE_TOKEN],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()  # "" if the server died before printing
        m = re.search(r" at (http://\S+) ", line)
        if m is None:
            raise SystemExit(f"chip_smoke: the origin printed {line!r}, no URL")
        yield m.group(1)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _same_tree(torch, got, want, what: str) -> None:
    from repro_torch.checkpoint.store import flatten

    g, w = flatten(got, "param"), flatten(want, "param")
    if g.keys() != w.keys():
        raise SystemExit(f"chip_smoke: {what}: leaves {sorted(g)} != {sorted(w)}")
    for name, t in w.items():
        if g[name].device != t.device or g[name].dtype != t.dtype or not torch.equal(g[name], t):
            raise SystemExit(f"chip_smoke: {what}: leaf {name} differs")


def _restore(torch, src: str, like) -> tuple:
    """``restore_pipelined`` of ``src`` onto the card from a cold client (no
    pooled sockets, empty block cache); the tree and its figures."""
    from repro_torch import remote
    from repro_torch.checkpoint import ColdStartStats, restore_pipelined

    remote.close_readers()
    remote.reset_shared_cache()
    st = ColdStartStats()
    got, _, _ = restore_pipelined(src, like, device=torch.device("cuda", 0), stats=st)
    return got, {**_cold(st), "resolve_s": st.resolve_s, "prewarmed_conns": st.prewarmed_conns,
                 "dequant_leaves": st.dequant_leaves}


def phase_remote(torch, keep: str, serve: dict, runs: list) -> dict:
    """The remote data plane: phase 4's CIFAR-10-shaped dataset and phase 5's
    InternLM2-1.8B checkpoints, all in ``keep``, served by the port's
    byte-range server; cold starts from its URL (raw, u8, through a fleet of
    3 edges cold and warm), ``ServeEngine`` from the URL, the device feed
    from the URL and a save to the URL, each held bit for bit against the
    same work on the local files."""
    from repro_torch import fleet, remote
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    import numpy as np

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S, max_new = serve["batch"], serve["prompt"], serve["max_new"]
    out: dict = {"arch": cfg.name, "transport": "loopback HTTP on one host: bound by the "
                 "host's CPUs and memory, not by a network"}
    model = build_model(cfg, device=dev, seed=SEED)  # weights replaced by every restore
    like = model.param_tree()
    local = {n: os.path.join(keep, n, "step_00000001") for n in ("raw", "u8")}
    out["phase5_local"] = {"raw": serve["raw_cold_start"], "u8": serve["u8_cold_start"]}
    prev_token = os.environ.get("RA_REMOTE_TOKEN")
    os.environ["RA_REMOTE_TOKEN"] = REMOTE_TOKEN  # the uploads' bearer token
    try:
        with _origin(keep) as origin:
            url = {n: f"{origin}/{n}/step_00000001" for n in local}

            # raw: the URL cold start against the local one, run here beside it
            want_raw, out["raw_local"] = _restore(torch, local["raw"], like)
            got, out["raw_url"] = _restore(torch, url["raw"], like)
            _same_tree(torch, got, want_raw, "raw URL cold start")
            del got

            # u8 (an f32 copy's codes): decoded on the card, one launch a leaf
            want, out["u8_local"] = _restore(torch, local["u8"], like)
            dequant_u8.launches = 0
            got, out["u8_url"] = _restore(torch, url["u8"], like)
            u8_launches = out["u8_url"]["dequant_launches"] = dequant_u8.launches
            _same_tree(torch, got, want, "u8 URL cold start")
            del got, want
            float_leaves = sum(1 for t in flatten(like, "param").values()
                               if t.is_floating_point() and t.dim())
            if not u8_launches == out["u8_url"]["dequant_leaves"] == float_leaves:
                raise SystemExit(f"chip_smoke: u8 URL cold start: {u8_launches} dequant "
                                 f"launches for {float_leaves} float leaves")

            # through a fleet of 3 edges and a router in front of the origin
            with fleet.serve(origin_url=origin, replicas=3, cache_bytes=EDGE_CACHE_BYTES,
                             spill=False) as fl:
                out["fleet"] = {"replicas": len(fl.edges), "edge_cache_bytes": EDGE_CACHE_BYTES}
                for run in ("cold", "warm"):
                    before = sum(e.edge_metrics()["origin_fetches"] for e in fl.edges)
                    got, row = _restore(torch, f"{fl.url}/raw/step_00000001", like)
                    _same_tree(torch, got, want_raw, f"raw cold start through the fleet ({run})")
                    del got
                    row["edge_ram_hits"] = [int(e.cache.stats()["hits"]) for e in fl.edges]
                    row["origin_fetches"] = sum(
                        e.edge_metrics()["origin_fetches"] for e in fl.edges) - before
                    out["fleet"][run] = row
            if out["fleet"]["warm"]["origin_fetches"] != 0:
                raise SystemExit(f"chip_smoke: the warm fleet went to the origin: {out['fleet']}")

            # serve from the URL: the tokens of phase 5's engine (local checkpoint)
            remote.close_readers()
            remote.reset_shared_cache()
            flash_attention.launches = flash_attention.tc_launches = decode_attention.launches = 0
            engine = ServeEngine(model, checkpoint=url["raw"])
            _same_tree(torch, model.param_tree(), want_raw, "ServeEngine from the URL")
            prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (B, S)).astype(np.int32)
            tokens = engine.generate(prompts, max_new=max_new)
            out["serve_url"] = {"cold_start": _cold(engine.cold_start),
                                "flash_attention_launches": flash_attention.launches,
                                "flash_attention_tc_launches": flash_attention.tc_launches,
                                "decode_attention_launches": decode_attention.launches,
                                **engine.throughput()}
            if (flash_attention.launches, flash_attention.tc_launches,
                    decode_attention.launches) != (cfg.n_layers, cfg.n_layers,
                                                   cfg.n_layers * max_new):
                raise SystemExit(f"chip_smoke: ServeEngine from the URL: {out['serve_url']}")
            if not np.array_equal(tokens, serve["tokens"]):
                raise SystemExit("chip_smoke: ServeEngine from the URL gave other tokens than "
                                 "phase 5's engine from the local checkpoint")
            out["serve_url"]["tokens_equal_local"] = True
            del engine

            # the device feed from the URL, every batch against the local files' host decode
            local_feed = next(r for r in runs if r["name"] == "cifar10_epoch")
            out["feed_url"] = _drive(torch, f"{origin}/cifar10_epoch", local_feed["batch"],
                                     local_feed["batches"],
                                     host_root=os.path.join(keep, "cifar10_epoch"))
            out["feed_local"] = {k: local_feed[k] for k in (
                "batches", "batch", "launches", "seconds", "batches_per_s", "h2d_gb_per_s")}

            # save to the URL (one PUT a leaf, the manifest last), then restore it
            saved = sum(t.numel() * t.element_size() for t in flatten(want_raw, "param").values())
            t0 = time.perf_counter()
            save_checkpoint(f"{origin}/saved", 1, want_raw)
            save_s = time.perf_counter() - t0
            got, row = _restore(torch, f"{origin}/saved/step_00000001", like)
            _same_tree(torch, got, want_raw, "checkpoint saved to the URL")
            del got, want_raw
            out["save_url"] = {"seconds": save_s, "bytes": saved,
                               "gb_per_s": saved / save_s / 1e9, "restore": row}
            remote.close_readers()
            remote.reset_shared_cache()
    finally:
        if prev_token is None:
            os.environ.pop("RA_REMOTE_TOKEN", None)
        else:
            os.environ["RA_REMOTE_TOKEN"] = prev_token
    log(f"[remote] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 13
#: the simulated hosts of phase 13b (tests/test_data_mesh.py:386's four)
MESH_HOSTS = ("h0", "h1", "h2", "h3")
#: paper_lm steps of each of phase 13d's two mesh-fed CLI runs
MESH_TRAIN_STEPS = 10


def _layer_specs(tree, stacked: bool = False):
    """Partition specs for a parameter tree: axis 0 (the layer axis) of every
    stacked layer leaf over ``"data"``, every other leaf replicated."""
    if isinstance(tree, dict):
        return {k: _layer_specs(v, stacked or k.endswith("layers")) for k, v in tree.items()}
    return ("data",) + (None,) * (tree.dim() - 1) if stacked else None


def _mesh_feed(torch, root: str, batch: int, dev) -> dict:
    """13a: one epoch of the global feed over a one-host mesh, each batch a
    DTensor held against the host decode of the same rows."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.distributed.data_mesh import DataMesh
    from repro_torch.kernels import dequant_u8

    feed = DeviceLoader(DataLoader(RaDataset(root), batch, seed=SEED, reuse_buffers=True,
                                   mesh=DataMesh("h0", ["h0"])), device=dev)
    if not feed.global_arrays or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise SystemExit(f"chip_smoke: the mesh feed is not global over a one-rank NCCL "
                         f"group: {feed.global_arrays}, {dist.get_backend()}")
    nbatches = feed.steps_per_epoch()
    tail = feed.stats()["dropped_tail_rows"]
    dequant_u8.launches = 0
    t0 = time.perf_counter()
    got = [next(feed)]
    first_s = time.perf_counter() - t0  # start-up, apart from the rate after it
    got += [next(feed) for _ in range(nbatches - 1)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feed.stop()
    launches = dequant_u8.launches
    stats = feed.stats()
    host = DataLoader(RaDataset(root), batch, seed=SEED, dequant=True,
                      mesh=DataMesh("h0", ["h0"]))
    try:
        for i, db in enumerate(got):
            hb = next(host)
            if hb["_state"].__dict__ != db["_state"].__dict__:
                raise SystemExit(f"chip_smoke: mesh batch {i} state {db['_state']} != "
                                 f"{hb['_state']}")
            for f in ("image", "label"):
                g = db[f]
                if not isinstance(g, DTensor) or g.device_mesh.device_type != "cuda" \
                        or tuple(g.shape) != hb[f].shape:
                    raise SystemExit(f"chip_smoke: mesh batch {i} {f} is not a global "
                                     f"DTensor on the card: {type(g)}")
                if not torch.equal(g.to_local().cpu(), torch.from_numpy(np.asarray(hb[f]))):
                    raise SystemExit(f"chip_smoke: mesh batch {i} {f} differs from the "
                                     "host decode")
    finally:
        host.stop()
    moved = int(stats["h2d_batches"])
    if launches != moved or not nbatches <= moved <= nbatches + feed.bufs + 1:
        raise SystemExit(f"chip_smoke: mesh feed: {launches} launches for {moved} moved "
                         f"batches ({nbatches} consumed)")
    return {"batches": nbatches, "batch": batch, "launches": launches, "moved": moved,
            "seconds": seconds, "batches_per_s": nbatches / seconds,
            "first_batch_s": first_s,
            "after_first_batches_per_s": (nbatches - 1) / (seconds - first_s),
            "dropped_tail_rows": tail,
            "h2d_gb_per_s": stats["h2d_bytes"] / stats["h2d_s"] / 1e9,
            "device_wait_s": stats["device_wait_s"]}


def _mesh_hosts(torch, root: str, batch: int, dev) -> dict:
    """13b: four simulated hosts in this process, each a mesh loader feeding
    ``DeviceLoader(global_arrays=False)`` on the card for one epoch: every
    row once across the hosts, every batch the host decode of its planned
    rows. Phase 4's dataset has 7 shards of up to 8,192 rows, which the ring
    deals per epoch; an epoch that leaves a host without a shard has zero
    lockstep steps (the loader's sticky error, as the reference's). The
    phase checks that epoch 0 is such an epoch, then runs the first epoch
    whose deal gives every host rows."""
    import numpy as np

    from repro_torch.core.spec import RawArrayError
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.distributed.data_mesh import DataMesh, owners_table
    from repro_torch.kernels import dequant_u8

    hosts = list(MESH_HOSTS)
    ds = RaDataset(root)
    shard_rows = [s["rows"] for s in owners_table(root, hosts)["shards"]]
    out: dict = {"hosts": hosts, "shards": len(shard_rows), "empty_epochs": []}
    epoch = 0
    while DataMesh("h0", hosts).plan(shard_rows, seed=SEED, epoch=epoch,
                                     batch_size=batch).steps() == 0:
        out["empty_epochs"].append({"epoch": epoch, "owners": [
            s["owner"] for s in owners_table(root, hosts, epoch=epoch)["shards"]]})
        epoch += 1
        if epoch > 16:
            raise SystemExit(f"chip_smoke: no epoch in 0..16 deals every host a shard: {out}")
    if out["empty_epochs"]:
        # the lockstep contract where a host owns nothing: zero steps, a sticky error
        dl = DataLoader(ds, batch, seed=SEED, mesh=DataMesh("h0", hosts))
        try:
            next(dl)
            raise SystemExit("chip_smoke: a zero-step mesh epoch delivered a batch")
        except RawArrayError as e:
            if "zero steps" not in str(e):
                raise
        finally:
            dl.stop()
    out["epoch"] = epoch
    feeds = {}
    for h in hosts:
        dl = DataLoader(RaDataset(root), batch, seed=SEED, reuse_buffers=True,
                        mesh=DataMesh(h, hosts))
        dl.seek(epoch, 0)
        feeds[h] = DeviceLoader(dl, global_arrays=False, device=dev)
    spe = {h: f.steps_per_epoch() for h, f in feeds.items()}
    tails = {h: f.stats()["dropped_tail_rows"] for h, f in feeds.items()}
    if len(set(spe.values())) != 1 or len(set(tails.values())) != 1:
        raise SystemExit(f"chip_smoke: steps per epoch {spe} or dropped tails {tails} "
                         "differ across hosts")
    steps = spe["h0"]
    plan = feeds["h0"].loader._mesh_plan(epoch)
    dequant_u8.launches = 0
    t0 = time.perf_counter()
    try:
        got = {h: [next(feed) for _ in range(steps)] for h, feed in feeds.items()}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        for feed in feeds.values():
            feed.stop()
    launches = dequant_u8.launches
    seen = []
    for h, batches in got.items():
        order = plan.host_order(h)
        for t, db in enumerate(batches):
            rows = order[t * batch:(t + 1) * batch]
            want = ds.gather(rows)
            img = ds.quant["image"].dequantize(want["image"])
            if db["_state"].epoch != epoch or db["_state"].step != t \
                    or not torch.equal(db["image"].cpu(), torch.from_numpy(img)) \
                    or not torch.equal(db["label"].cpu(), torch.from_numpy(want["label"])):
                raise SystemExit(f"chip_smoke: host {h} batch {t} is not the host decode "
                                 "of its planned rows")
            seen.append(rows)
    del got
    allr = np.concatenate(seen)
    once = len(np.unique(allr)) == len(allr) == steps * batch * len(hosts)
    if not once or len(allr) + tails["h0"] != ds.total_rows:
        raise SystemExit(f"chip_smoke: four hosts: rows once {once}, {len(allr)} rows + "
                         f"{tails['h0']} dropped of {ds.total_rows}")
    moved = sum(int(f.stats()["h2d_batches"]) for f in feeds.values())
    if launches != moved:
        raise SystemExit(f"chip_smoke: four hosts: {launches} launches for {moved} batches")
    out.update(steps_per_epoch=steps, rows_delivered=int(len(allr)),
               dropped_tail_rows=tails["h0"], launches=launches, moved=moved,
               seconds=seconds, batches_per_s=steps * len(hosts) / seconds,
               owned_rows={h: t["rows"] for h, t in
                           owners_table(root, hosts, epoch=epoch)["per_host"].items()})
    return out


def _mesh_restore(torch, keep: str, dev) -> dict:
    """13c: phase 5's raw and u8 InternLM2 checkpoints restored onto the
    one-rank mesh with the layer axis of every stacked leaf sharded, each
    leaf's local block bit-equal to the unsharded restore run beside it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import ColdStartStats, restore_pipelined, shardings_from_specs
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.distributed.data_mesh import data_sharding
    from repro_torch.kernels import dequant_u8
    from repro_torch.models import build_model

    cfg = get_config("internlm2_1_8b")
    like = build_model(cfg, device=dev, seed=SEED).param_tree()
    mesh = data_sharding(device=dev)[0]
    sh = shardings_from_specs(mesh, _layer_specs(like))
    n_sharded = sum(1 for s in flatten(_layer_specs(like), "param").values() if s)
    out: dict = {"arch": cfg.name, "sharded_leaves": n_sharded, "mesh": list(mesh.shape)}
    for name in ("raw", "u8"):
        path = os.path.join(keep, name, "step_00000001")
        plain_st, mesh_st = ColdStartStats(), ColdStartStats()
        dequant_u8.launches = 0
        want, _, _ = restore_pipelined(path, like, device=dev, stats=plain_st)
        plain_launches = dequant_u8.launches
        dequant_u8.launches = 0
        got, _, _ = restore_pipelined(path, like, device=dev, shardings=sh, stats=mesh_st)
        mesh_launches = dequant_u8.launches
        want, got = flatten(want, "param"), flatten(got, "param")
        floats = sum(1 for t in want.values() if t.is_floating_point() and t.dim())
        # every leaf has a placement (None specs replicate), so the u8 leaves
        # decode on the host; the unsharded restore decodes them on the card
        if mesh_launches != 0 or plain_launches != mesh_st.dequant_leaves \
                or mesh_st.dequant_leaves != (floats if name == "u8" else 0):
            raise SystemExit(f"chip_smoke: sharded restore ({name}): {mesh_launches} and "
                             f"{plain_launches} dequant launches, {mesh_st.dequant_leaves} "
                             "decoded leaves")
        for leaf, w in want.items():
            g = got[leaf]
            if not isinstance(g, DTensor) or g.device_mesh is not mesh:
                raise SystemExit(f"chip_smoke: sharded restore ({name}): {leaf} is {type(g)}")
            local = g.to_local()
            if local.device != dev or local.dtype != w.dtype or not torch.equal(local, w):
                raise SystemExit(f"chip_smoke: sharded restore ({name}): {leaf} differs from "
                                 "the unsharded restore")
        del want, got
        out[name] = {"unsharded": {**_cold(plain_st), "dequant_launches": plain_launches},
                     "sharded": {**_cold(mesh_st), "dequant_launches": mesh_launches,
                                 "dequant_leaves": mesh_st.dequant_leaves}}
        torch.cuda.empty_cache()
    return out


def _mesh_training(torch, dev) -> dict:
    """13d: paper_lm through the CLI with the device feed on a one-host
    mesh, once by flags and once by ``RA_MESH_HOSTS``/``RA_MESH_HOST``: the
    same rows, so the same losses; the flash launches of each run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import parse_args, run

    cfg = get_config("paper_lm")
    out: dict = {"arch": cfg.name, "steps": MESH_TRAIN_STEPS}
    saved = {k: os.environ.pop(k, None) for k in ("RA_MESH_HOSTS", "RA_MESH_HOST")}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            ds = os.path.join(tmp, "flags", "dataset")  # the first run builds it
            for how, extra in (("flags", ["--mesh-hosts", "h0", "--mesh-host", "h0"]),
                               ("env", ["--dataset", ds])):
                if how == "env":
                    os.environ["RA_MESH_HOSTS"] = os.environ["RA_MESH_HOST"] = "h0"
                args = parse_args(["--arch", "paper_lm", "--device-feed", "--batch", "8",
                                   "--steps", str(MESH_TRAIN_STEPS), "--ckpt-every", "1000",
                                   "--seed", str(SEED), "--device", str(dev), "--fresh",
                                   "--workdir", os.path.join(tmp, how), *extra])
                if args.mesh is None or args.mesh.hosts != ("h0",):
                    raise SystemExit(f"chip_smoke: the {how} run has no one-host mesh")
                _reset_flash_counts()
                res = run(args)
                torch.cuda.synchronize()
                launches = _flash_counts()
                want = {"forward": cfg.n_layers * MESH_TRAIN_STEPS * (2 if cfg.remat else 1),
                        "backward": cfg.n_layers * MESH_TRAIN_STEPS}
                if launches != want:
                    raise SystemExit(f"chip_smoke: mesh {how} run launched {launches}, "
                                     f"wanted {want}")
                out[how] = {"losses": res["losses"], "launches": launches,
                            "median_step_s": statistics.median(res["step_s"]),
                            "wall_s": res["wall_s"],
                            "dropped_tail_rows": res["loader_stats"]["dropped_tail_rows"]}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["losses_equal"] = out["flags"]["losses"] == out["env"]["losses"]
    if not out["losses_equal"]:
        raise SystemExit(f"chip_smoke: flag and env mesh runs differ: {out}")
    return out


def phase_data_mesh(torch, keep: str, runs: list) -> dict:
    """The data mesh on the card: phase 4's CIFAR-10-shaped dataset through
    a one-host mesh's global feed (a one-rank NCCL group) and through four
    simulated hosts, phase 5's InternLM2 checkpoints restored onto the mesh,
    and the train CLI fed by its mesh from flags and from the environment."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    root = os.path.join(keep, "cifar10_epoch")
    local = next(r for r in runs if r["name"] == "cifar10_epoch")
    out: dict = {"rows": local["rows"]}
    try:
        out["global_feed"] = _mesh_feed(torch, root, local["batch"], dev)
        out["global_feed"]["phase4_batches_per_s"] = local["batches_per_s"]
        out["four_hosts"] = _mesh_hosts(torch, root, local["batch"], dev)
        out["restore"] = _mesh_restore(torch, keep, dev)
        out["training"] = _mesh_training(torch, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    log(f"[data mesh] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 14
#: (prompts, text tokens after the 1,152 patches) of phase 14's model.prefill
#: runs; 1,152 + 3,200 = 4,352 positions cross the window of 4,096
LLAVA_PREFILLS = ((4, 1024), (1, 3200))


def phase_llava_serving(torch) -> dict:
    """llava-next-mistral-7b at its full size: raw checkpoint, cold start,
    the model's prefill with image patches (the vlm path), then a batch of
    text-only requests through the engine (as the JAX engine serves it)."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("llava_next_mistral_7b")
    B, S, max_new, P, L = 8, 512, 64, cfg.n_patches, cfg.n_layers
    out: dict = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model, "heads": cfg.n_heads,
                 "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                 "vocab": cfg.vocab, "sliding_window": cfg.sliding_window, "n_patches": P,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    _temper_attention(torch, model)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_llava_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved
    torch.cuda.empty_cache()
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)

    # (a) the vlm path: model.prefill with the stub vision front end's patches
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out["prefill"] = []
    for b, s in LLAVA_PREFILLS:
        tokens = torch.randint(1, cfg.vocab, (b, s), device=dev, generator=gen)
        patches = (torch.randn((b, P, cfg.d_model), device=dev, generator=gen) * 0.1).to(
            cfg.cdtype)
        row = {"batch": b, "patches": P, "tokens": s, "positions": P + s,
               "past_window": P + s > cfg.sliding_window}
        torch.cuda.synchronize()
        _reset_counts(kernels)
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens, patches)
        torch.cuda.synchronize()
        row["first_prefill_s"] = time.perf_counter() - t0
        row["launches"] = _counts(kernels)
        want = {"dequant_u8": 0, "flash_attention": L, "decode_attention": 0, "ssd_scan": 0,
                "flash_attention_tc": L}
        if row["launches"] != want or int(cache["pos"]) != P + s:
            raise SystemExit(f"chip_smoke: llava prefill launched {row['launches']} with pos "
                             f"{int(cache['pos'])}, wanted {want} and {P + s}")
        del cache
        t0 = time.perf_counter()
        model.prefill(tokens, patches)  # warm: launches from here on are not counted
        torch.cuda.synchronize()
        row["prefill_s"] = time.perf_counter() - t0
        with _plain_attention():
            plain = model.prefill(tokens, patches)[0].float()
        _first_logits_gate(torch, row, "last_logits", logits.float(), plain,
                           f"llava prefill ({b} x {P} + {s}) last-position logits")
        out["prefill"].append(row)
        del logits, plain, tokens, patches
        torch.cuda.empty_cache()

    # (b) text-only requests through the engine
    prompts = np.random.default_rng(SEED + 6).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(kernels)
    tokens = engine.generate(prompts, max_new=max_new)
    launches = _counts(kernels)
    out["launches"] = launches
    out["flash_attention_launches"] = launches["flash_attention"]
    out["flash_attention_tc_launches"] = launches["flash_attention_tc"]
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": L, "decode_attention": L * max_new,
            "ssd_scan": 0, "flash_attention_tc": L}
    if launches != want:
        raise SystemExit(f"chip_smoke: llava generate launched {launches}, wanted {want}")
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    _first_logits_gate(torch, out, "first_logits", first, plain_first,
                       "llava first-step logits")
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    del engine, model
    torch.cuda.empty_cache()
    log(f"[llava serving] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 15
@contextlib.contextmanager
def _launches_by_kind(kinds: dict, enc_rows: int):
    """Attribute each attention call's kernel launches (the kernel wrappers'
    own counts) to the kind of attention that made it: flash ``encoder``
    (non-causal, Sq = Sk), ``decoder`` (causal) and ``cross`` (non-causal,
    Sq != Sk); decode ``self_decode`` and ``cross_decode`` (over the
    ``enc_rows`` encoder states)."""
    from repro_torch.kernels import decode_attention, flash_attention, ops

    kept = ops.flash_attention, ops.decode_attention

    def tally(kind, before, after):
        kinds[kind] = kinds.get(kind, 0) + after - before

    def flash(q, k, v, *, causal=True, **kw):
        before = flash_attention.launches
        o = kept[0](q, k, v, causal=causal, **kw)
        kind = "decoder" if causal else "encoder" if q.shape[2] == k.shape[2] else "cross"
        tally(kind, before, flash_attention.launches)
        return o

    def decode(q, k, v, pos, **kw):
        before = decode_attention.launches
        o = kept[1](q, k, v, pos, **kw)
        tally("cross_decode" if k.shape[2] == enc_rows else "self_decode", before,
              decode_attention.launches)
        return o

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = kept


def _whisper_generate(torch, model, frames, prompts, max_new: int) -> tuple:
    """The JAX engine's algorithm for attention families
    (``src/repro/serving/engine.py:106-112``) on the model's own entry
    points, which its engine cannot call (it passes no frames): prefill the
    first S-1 prompt tokens right-padded to the capacity S + max_new with the
    frames, rewind ``pos`` to S-1, feed the last prompt token as a decode
    step, then greedy decode steps. Returns (tokens (B, max_new) on the host,
    the first step's logits, {prefill_s, decode_s, decode_tok_per_s})."""
    B, S = prompts.shape
    dev = model.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    padded = torch.zeros((B, S + max_new), dtype=torch.long, device=dev)
    padded[:, :S - 1] = prompts[:, :S - 1]
    _, cache = model.prefill(frames, padded)
    cache["pos"] = torch.full((), S - 1, dtype=torch.int32, device=dev)
    logits, cache = model.decode_step(cache, prompts[:, S - 1:])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = logits.float()
    t0 = time.perf_counter()
    toks = [logits.argmax(-1, keepdim=True)]
    for _ in range(1, max_new):
        logits, cache = model.decode_step(cache, toks[-1])
        toks.append(logits.argmax(-1, keepdim=True))
    out = torch.cat(toks, dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t0
    return out, first, {"prefill_s": prefill_s, "decode_s": decode_s,
                        "decode_tok_per_s": B * max_new / decode_s}


def phase_whisper_serving(torch) -> dict:
    """whisper-medium at its full size: raw checkpoint restored onto a
    meta-device model, the encoder over 1,500 frames, and 8 requests served
    by the engine's algorithm on the model's own prefill and decode_step."""
    import numpy as np

    from repro_torch.checkpoint import ColdStartStats, restore_pipelined, save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params

    dev = torch.device("cuda", 0)
    cfg = get_config("whisper_medium")
    B, S, max_new, L = 8, 16, 112, cfg.n_layers
    out: dict = {"arch": cfg.name, "enc_layers": cfg.n_enc_layers, "dec_layers": L,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "head_dim": cfg.head_dim,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab, "enc_seq": cfg.enc_seq,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    src = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    _temper_attention(torch, src)
    saved = flatten(src.param_tree(), "param")
    out["params"] = sum(t.numel() for t in saved.values())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_whisper_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, src.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        del src
        model = build_model(cfg, device="meta")  # the cold start fills it
        st = ColdStartStats()
        params, _, _ = restore_pipelined(raw, model.param_tree(), device=dev, stats=st)
        load_params(model, params)
        del params
        out["raw_cold_start"] = _cold(st)
    if model.device != dev:
        raise SystemExit(f"chip_smoke: the restored whisper model is on {model.device}")
    for name, t in flatten(model.param_tree(), "param").items():
        if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
            raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
    del saved
    torch.cuda.empty_cache()
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    frames = (torch.randn((B, cfg.enc_seq, cfg.d_model), device=dev, generator=gen) * 0.1).to(
        cfg.cdtype)  # the stub audio front end's output
    prompts = torch.randint(1, cfg.vocab, (B, S), device=dev, generator=gen)

    # the encoder alone: 24 non-causal flash launches over the 1,500 frames
    torch.cuda.synchronize()
    _reset_counts(kernels)
    enc = model.encode(frames)
    torch.cuda.synchronize()
    out["encode_launches"] = _counts(kernels)
    want = {"dequant_u8": 0, "flash_attention": cfg.n_enc_layers, "decode_attention": 0,
            "ssd_scan": 0, "flash_attention_tc": cfg.n_enc_layers}
    if out["encode_launches"] != want:
        raise SystemExit(f"chip_smoke: whisper encode launched {out['encode_launches']}, "
                         f"wanted {want}")
    t0 = time.perf_counter()
    model.encode(frames)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0
    with _plain_attention():
        plain_enc = model.encode(frames)
    _first_logits_gate(torch, out, "encoder_output", enc.float(), plain_enc.float(),
                       "whisper encoder states")
    del enc, plain_enc

    # the main path: 8 requests, counted by attention kind
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(kernels)
    kinds: dict = {}
    with _launches_by_kind(kinds, cfg.enc_seq):
        tokens, first, stats = _whisper_generate(torch, model, frames, prompts, max_new)
    launches = _counts(kernels)
    out.update(stats)
    out["launches"] = launches
    out["launches_by_kind"] = kinds
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: whisper gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": cfg.n_enc_layers + 2 * L,
            "decode_attention": 2 * L * max_new, "ssd_scan": 0,
            "flash_attention_tc": cfg.n_enc_layers + 2 * L}
    want_kinds = {"encoder": cfg.n_enc_layers, "decoder": L, "cross": L,
                  "self_decode": L * max_new, "cross_decode": L * max_new}
    if launches != want or kinds != want_kinds:
        raise SystemExit(f"chip_smoke: whisper launched {launches} ({kinds}), wanted {want} "
                         f"({want_kinds})")
    out["warm"] = _whisper_generate(torch, model, frames, prompts, max_new)[2]
    out["profiled_steps"] = _profiled_steps(torch, model, prompts.cpu().numpy(), S + max_new)
    with _plain_attention():
        plain_tokens, plain_first, _ = _whisper_generate(torch, model, frames, prompts, max_new)
    _first_logits_gate(torch, out, "first_logits", first, plain_first,
                       "whisper first-step logits")
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    # the cross-attention K/V every decode step reads: 24 layers of (8, 16, 1,500, 64) × 2
    esize = torch.empty(0, dtype=cfg.cdtype).element_size()
    cross_bytes = 2 * L * B * cfg.n_heads * cfg.enc_seq * cfg.head_dim * esize
    out["cross_kv_bytes_per_step"] = cross_bytes
    out["cross_kv_bound_ms_per_step"] = cross_bytes / HBM_BYTES_PER_S * 1e3
    del model, frames
    torch.cuda.empty_cache()
    log(f"[whisper serving] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 16
WHISPER_TRAIN_STEPS, WHISPER_RESUME_AT = 6, 4
#: decoder tokens a training row: the reference's ENCDEC_TGT (src/repro/launch/shapes.py:40)
WHISPER_TEXT = 448
#: the float fields of the training datasets are stored as u8 codes over this range
FEED_RANGE = (-0.5, 0.5)
#: llava-next-mistral-7b's train row: 1,152 patches + 2,944 tokens = 4,096 positions
#: (src/repro/launch/shapes.py:68-75); its depth cut from 32 layers (PERF.md §4)
LLAVA_TRAIN_LAYERS, LLAVA_TRAIN_TEXT, LLAVA_TRAIN_STEPS = 22, 2944, 4


def _u8_dataset(root: str, fields: dict, quantized: str, rows: int, make, chunk: int) -> float:
    """A RawArray dataset of ``rows`` rows with the float field ``quantized``
    stored as u8 codes over ``FEED_RANGE`` (the paper's archival format);
    ``make(n)`` gives the next n rows as numpy arrays. Returns its seconds."""
    from repro_torch.data import DatasetBuilder

    t0 = time.perf_counter()
    builder = DatasetBuilder(root, fields, shard_rows=rows,
                             quantize={quantized: ("u8", *FEED_RANGE)})
    for lo in range(0, rows, chunk):
        builder.append(**make(min(chunk, rows - lo)))
    builder.finish()
    return time.perf_counter() - t0


def _host_batch(torch, root: str, B: int) -> dict:
    """The first batch of a host ``DataLoader`` over ``root`` (u8 fields
    decoded on the host) as CPU tensors: the first step's batch."""
    import numpy as np

    from repro_torch.data import DataLoader, RaDataset

    host = DataLoader(RaDataset(root), B, seed=SEED)
    try:
        batch = next(host)
    finally:
        host.stop()
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items() if k != "_state"}


@contextlib.contextmanager
def _bwd_launches_by_kind(kinds: dict):
    """Attribute the backward kernel's launches (its wrapper's own count) to
    the kind of attention whose gradient it took, by its shapes: ``encoder``
    (non-causal, Sq = Sk), ``decoder`` (causal) and ``cross`` (Sq != Sk)."""
    from repro_torch.kernels import flash_attention as fa

    kept = fa.flash_attention_bwd

    def counted(q, k, *args, causal=True, **kw):
        before = fa.bwd_launches
        grads = kept(q, k, *args, causal=causal, **kw)
        kind = "decoder" if causal else "encoder" if q.shape[2] == k.shape[2] else "cross"
        kinds[kind] = kinds.get(kind, 0) + fa.bwd_launches - before
        return grads

    fa.flash_attention_bwd = counted
    try:
        yield
    finally:
        fa.flash_attention_bwd = kept


def _step_row(torch, res: dict, dev, tokens: int) -> dict:
    """A train() run's numbers: losses, step times (the first step, which
    warms the allocator, left out of the median), decoder tokens/s, peak
    device memory."""
    step = statistics.median(res["step_s"][1:])
    return {"losses": res["losses"], "step_s": res["step_s"], "median_step_s": step,
            "tokens_per_s": tokens / step,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}


def phase_whisper_training(torch) -> dict:
    """whisper-medium at full size (nothing cut): the first step against
    plain attention, 6 steps of ``train()`` on u8 frames through
    ``DeviceLoader`` with a checkpoint at step 4, and a second ``train()``
    that resumes there for the last 2 steps."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.data.synth import markov_tokens
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.kernels import dequant_u8
    from repro_torch.models import build_model
    from repro_torch.train import TrainLoopConfig, train

    dev = torch.device("cuda", 0)
    cfg = get_config("whisper_medium")
    B, S_audio, S_text, steps = 8, cfg.enc_seq, WHISPER_TEXT, WHISPER_TRAIN_STEPS
    per_step = cfg.n_enc_layers + 2 * cfg.n_layers  # attention calls a step
    out: dict = {"arch": cfg.name, "enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "head_dim": cfg.head_dim,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
                 "remat": cfg.remat, "batch": B, "frames": S_audio, "text": S_text,
                 "steps": steps, "resume_at": WHISPER_RESUME_AT}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    adamw = AdamWConfig(lr=1e-3, warmup_steps=2)
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_whisper_train_") as tmp:
        root = os.path.join(tmp, "audio")
        out["dataset_s"] = _u8_dataset(
            root, {"frames": ((S_audio, cfg.d_model), "float32"), "tokens": ((S_text,), "int32")},
            "frames", 64, lambda n: {
                "frames": rng.standard_normal((n, S_audio, cfg.d_model), dtype=np.float32) * 0.1,
                "tokens": markov_tokens(rng, rng.permutation(cfg.vocab), n,
                                        S_text).astype(np.int32)}, chunk=8)
        batch = _host_batch(torch, root, B)
        out["first_step"] = _first_step_gates(torch, model, batch, "whisper", out,
                                              reference="plain backward")
        torch.cuda.empty_cache()

        def run(ckpt_dir, n, resume):
            feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                                device=dev)
            return train(model, feed, TrainLoopConfig(
                steps=n, ckpt_every=WHISPER_RESUME_AT, ckpt_dir=ckpt_dir, log_every=1,
                adamw=adamw), resume=resume)

        ckpt = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        dequant_u8.launches = 0
        fwd_kinds, bwd_kinds = {}, {}
        with _launches_by_kind(fwd_kinds, S_audio), _bwd_launches_by_kind(bwd_kinds):
            res = run(ckpt, steps, resume=False)
        torch.cuda.synchronize()
        launches = {**_flash_counts(), "dequant_u8": dequant_u8.launches}
        row = _train_row(res, per_step, cfg.remat)
        row.update(_step_row(torch, res, dev, B * S_text))
        row["frames_per_s"] = B * S_audio / row["median_step_s"]
        row["launches"] = launches
        row["forward_launches_by_kind"] = fwd_kinds
        row["backward_launches_by_kind"] = bwd_kinds
        out["train"] = row
        log(f"[whisper training] steps {json.dumps(row)}")
        want_kinds = {"encoder": cfg.n_enc_layers * steps, "decoder": cfg.n_layers * steps,
                      "cross": cfg.n_layers * steps}
        mult = 2 if cfg.remat else 1
        if not all(np.isfinite(res["losses"])) or res["losses"][-1] >= res["losses"][0]:
            raise SystemExit(f"chip_smoke: whisper training: losses {res['losses']}")
        if {k: launches[k] for k in ("forward", "backward")} != row["want_launches"] or \
                fwd_kinds != {k: n * mult for k, n in want_kinds.items()} or \
                bwd_kinds != want_kinds or launches["dequant_u8"] < steps:
            raise SystemExit(f"chip_smoke: whisper training launched {launches} (forward "
                             f"{fwd_kinds}, backward {bwd_kinds}), wanted "
                             f"{row['want_launches']} and {want_kinds}, a dequant a batch")

        # a second train() from the step-4 checkpoint (hard links in a directory
        # of its own) for the last 2 steps: within the resume gate of the first's
        straight = res["losses"]
        del res
        torch.cuda.empty_cache()
        name = f"step_{WHISPER_RESUME_AT:08d}"
        again = os.path.join(tmp, "resume")
        shutil.copytree(os.path.join(ckpt, name), os.path.join(again, name),
                        copy_function=os.link)
        _reset_flash_counts()
        with _tee_stdout() as printed:
            res = run(again, steps, resume=True)
        torch.cuda.synchronize()
        resumed = {"losses": res["losses"], "straight_losses": straight[WHISPER_RESUME_AT:],
                   "resume_s": res["cold_start"].restore_s if res["cold_start"] else None,
                   "cold_start": _cold(res["cold_start"]) if res["cold_start"] else None,
                   "launches": _flash_counts(),
                   "bit_equal": res["losses"] == straight[WHISPER_RESUME_AT:]}
        out["resume"] = resumed
        del res
        if f"resumed from step {WHISPER_RESUME_AT}" not in printed.getvalue() or \
                len(resumed["losses"]) != steps - WHISPER_RESUME_AT or \
                not np.allclose(resumed["losses"], straight[WHISPER_RESUME_AT:],
                                rtol=1e-5, atol=1e-6):
            raise SystemExit(f"chip_smoke: the whisper resume differs: {resumed}")
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch)
    del model
    torch.cuda.empty_cache()
    log(f"[whisper training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 17
def phase_llava_training(torch) -> dict:
    """llava-next-mistral-7b at full widths and a cut depth: the first step
    against plain attention, then 4 steps of the train loop's step on
    ``DeviceLoader`` batches whose patch embeddings are stored as u8."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.data.synth import markov_tokens
    from repro_torch.distributed import optimizer as optim
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.kernels import dequant_u8
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step

    dev = torch.device("cuda", 0)
    published = get_config("llava_next_mistral_7b")
    cfg = published.with_(n_layers=LLAVA_TRAIN_LAYERS)
    B, P, S, steps = 2, cfg.n_patches, LLAVA_TRAIN_TEXT, LLAVA_TRAIN_STEPS
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": published.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "sliding_window": cfg.sliding_window, "dtype": cfg.param_dtype,
                 "remat": cfg.remat, "batch": B, "patches": P, "text": S, "steps": steps}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    adamw = AdamWConfig(lr=1e-3, warmup_steps=2)
    rng = np.random.default_rng(6)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llava_train_") as tmp:
        root = os.path.join(tmp, "vlm")
        out["dataset_s"] = _u8_dataset(
            root, {"patch_embeds": ((P, cfg.d_model), "float32"), "tokens": ((S,), "int32")},
            "patch_embeds", 16, lambda n: {
                "patch_embeds": rng.standard_normal((n, P, cfg.d_model), dtype=np.float32) * 0.1,
                "tokens": markov_tokens(rng, rng.permutation(cfg.vocab), n,
                                        S).astype(np.int32)}, chunk=8)
        batch = _host_batch(torch, root, B)
        # plain attention in f32 and in f64 already differ past the tolerance at
        # this model's first step (see _first_step_gates)
        out["first_step"] = _first_step_gates(torch, model, batch, "llava", out,
                                              reference="plain backward")
        torch.cuda.empty_cache()

        params = model.param_tree()
        state = optim.init_state(params, adamw)
        step_fn = make_step(model, adamw)
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        dequant_u8.launches = 0
        res = {"losses": [], "step_s": []}
        try:
            for _ in range(steps):
                feed_batch = next(feed)
                feed_batch.pop("_state", None)
                t0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, feed_batch)
                res["losses"].append(float(metrics["loss"]))
                res["step_s"].append(time.perf_counter() - t0)
        finally:
            feed.stop()
        torch.cuda.synchronize()
    launches = {**_flash_counts(), "dequant_u8": dequant_u8.launches}
    row = _step_row(torch, res, dev, B * S)
    row["positions_per_s"] = B * (P + S) / row["median_step_s"]
    row["model_tflops_per_s"] = 6 * out["params"] * B * (P + S) / row["median_step_s"] / 1e12
    row["launches"] = launches
    row["want_launches"] = {"forward": cfg.n_layers * steps * (2 if cfg.remat else 1),
                            "backward": cfg.n_layers * steps}
    out["train"] = row
    log(f"[llava training] steps {json.dumps(row)}")
    if not all(np.isfinite(res["losses"])) or res["losses"][-1] >= res["losses"][0]:
        raise SystemExit(f"chip_smoke: llava training: losses {res['losses']}")
    if {k: launches[k] for k in ("forward", "backward")} != row["want_launches"] or \
            launches["dequant_u8"] < steps:
        raise SystemExit(f"chip_smoke: llava training launched {launches}, wanted "
                         f"{row['want_launches']} and a dequant a batch")
    del state, params
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch)
    del model
    torch.cuda.empty_cache()
    log(f"[llava training] {json.dumps(out)}")
    return out


# ----------------------------------------------------------- phases 18-19
#: the moe family's serving cuts (of 61 layers): the dense prefix kept whole
#: where it fits, one MoE layer each (PERF.md §4 has the byte arithmetic)
MOE_LAYERS = {"kimi_k2_1t": 2, "deepseek_v3_671b": 4}


@contextlib.contextmanager
def _routes(record=None, replay=None):
    """Each MoE routing call's (expert ids, gates), in call order: appended
    to ``record``, or, with ``replay``, taken from an earlier run's record
    (the call's own aux loss kept), for this script's comparison only."""
    from repro_torch.models import moe

    kept = moe.route
    given = iter(replay) if replay is not None else None

    def route(p, x2d, cfg):
        idx, gates, aux = kept(p, x2d, cfg)
        if given is not None:
            idx, gates = next(given)
        if record is not None:
            record.append((idx, gates))
        return idx, gates, aux

    moe.route = route
    try:
        yield
    finally:
        moe.route = kept


def _route_diff(torch, got: list, want: list) -> dict:
    """(token, k) routes that differ between two runs' records: each token's
    experts compared as sets (sorted ids), so only a changed choice counts."""
    if len(got) != len(want):
        raise SystemExit(f"chip_smoke: {len(got)} routing calls against {len(want)}")
    differ = total = tokens = 0
    for (a, _), (b, _) in zip(got, want):
        ne = torch.sort(a, -1).values != torch.sort(b, -1).values
        differ += int(ne.sum())
        tokens += int(ne.any(-1).sum())
        total += ne.numel()
    return {"routes": total, "routes_differ": differ, "share": differ / total,
            "tokens_with_a_changed_route": tokens}


def _moe_logits_gates(torch, engine, model, prompts, capacity: int, out: dict):
    """First-prefill and first-step logits against plain attention's, and
    the routes that differ between the two runs. Where the free-routed
    comparison misses ``LOGITS_TOL``, it is made again with the kernel run
    held to the plain run's routes (expert ids and gates): a near-tie in the
    top-k that the two roundings break differently swaps a whole expert's
    output, which is routing, not attention."""
    tokens = torch.from_numpy(prompts.astype("int64")).to(model.device)
    plain_routes, routes = [], []
    with _plain_attention():
        with _routes(record=plain_routes):
            plain_prefill = model.prefill(tokens)[0].float()
            plain_first = engine._prefill_with_capacity(prompts, capacity)[0].float()
        plain_tokens = engine.generate(prompts, max_new=capacity - prompts.shape[1])
    with _routes(record=routes):
        prefill = model.prefill(tokens)[0].float()
        first = engine._prefill_with_capacity(prompts, capacity)[0].float()
    out["routes_vs_plain_attention"] = _route_diff(torch, routes, plain_routes)
    gates = {}
    for key, got, plain, what in (("first_prefill_logits", prefill, plain_prefill, "prefill"),
                                  ("first_step_logits", first, plain_first, "first step")):
        try:
            _first_logits_gate(torch, gates, key, got, plain, f"{out['arch']} {what} logits")
            gates[key]["routes"] = "free"
        except SystemExit:
            log(f"[moe serving] {what} logits miss the gate with free routes: {gates[key]}; "
                "again under the plain run's routes")
            with _routes(replay=plain_routes):
                again = (model.prefill(tokens)[0].float(),
                         engine._prefill_with_capacity(prompts, capacity)[0].float())
            free = gates[key]
            _first_logits_gate(torch, gates, key, again[0 if key.endswith("prefill_logits") else 1],
                               plain, f"{out['arch']} {what} logits under the plain routes")
            gates[key].update(routes="held to the plain run's", free_routes=free)
    out.update(gates)
    return plain_tokens


def _moe_serving(torch, arch: str, cold_start: bool, card: str) -> dict:
    """One moe config at full width, its depth cut to ``MOE_LAYERS``, bf16,
    random weights from seed 0 built on the card and tempered; with
    ``cold_start`` saved as a raw checkpoint and restored onto a meta-device
    model by ``restore_pipelined`` (bit-equal) before it serves. Then 8
    prompts of 512 tokens with 64 new tokens each through the engine. The
    line it prints names the card and its power limit (``card``, as
    ``nvidia-smi`` gives them) beside the rates."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    full = get_config(arch)
    cfg = full.with_(n_layers=MOE_LAYERS[arch])
    m = cfg.moe
    B, S, max_new, L = 8, 512, 64, cfg.n_layers
    out: dict = {"arch": cfg.name, "layers": L, "of_layers": full.n_layers,
                 "dense_layers": m.first_dense, "moe_layers": L - m.first_dense,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "attn_type": cfg.attn_type, "experts": m.n_experts, "top_k": m.top_k,
                 "shared_experts": m.n_shared, "d_ff_expert": m.d_ff_expert,
                 "dispatch_chunks": m.dispatch_chunks, "vocab": cfg.vocab,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new,
                 "card": card}
    if cfg.attn_type == "mla":
        out["mla"] = {"q_lora": cfg.mla.q_lora_rank, "kv_lora": cfg.mla.kv_lora_rank,
                      "rope": cfg.mla.qk_rope_head_dim, "nope": cfg.mla.qk_nope_head_dim,
                      "v": cfg.mla.v_head_dim, "mtp_carried": cfg.mtp}
    else:
        out["head_dim"] = cfg.head_dim
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["init_peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    _temper_attention(torch, model)
    out["params"] = sum(t.numel() for t in model.parameters())
    out["param_bytes"] = sum(t.numel() * t.element_size() for t in model.parameters())

    if cold_start:
        saved = flatten(model.param_tree(), "param")
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{arch}_") as tmp:
            t0 = time.perf_counter()
            raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
            out["save_raw_s"] = time.perf_counter() - t0
            out["largest_leaf_bytes"] = max(t.numel() * t.element_size() for t in saved.values())
            engine = ServeEngine(build_model(cfg, device="meta"), checkpoint=raw, device=dev)
            for name, t in flatten(engine.model.param_tree(), "param").items():
                if t.device != dev or not torch.equal(t, saved[name]):
                    raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
            out["raw_cold_start"] = _cold(engine.cold_start)
        del saved, model
        model = engine.model
        torch.cuda.empty_cache()
    else:
        engine = ServeEngine(model)
    if engine.device != dev:
        raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")

    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    prompts = np.random.default_rng(SEED + 7).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(kernels)
    tokens = engine.generate(prompts, max_new=max_new)
    launches = _counts(kernels)
    out["launches"] = launches
    out["flash_attention_launches"] = launches["flash_attention"]
    out["flash_attention_tc_launches"] = launches["flash_attention_tc"]
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": L, "decode_attention": L * max_new,
            "ssd_scan": 0, "flash_attention_tc": L}
    if launches != want:
        raise SystemExit(f"chip_smoke: {arch} generate launched {launches}, wanted {want}")
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    plain_tokens = _moe_logits_gates(torch, engine, model, prompts, S + max_new, out)
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    del engine, model
    torch.cuda.empty_cache()
    log(f"[moe serving] {json.dumps(out)}")
    return out


def phase_kimi_serving(torch, card: str) -> dict:
    """kimi-k2-1t-a32b at full widths, 2 of 61 layers: GQA at head width 112."""
    return _moe_serving(torch, "kimi_k2_1t", cold_start=False, card=card)


def phase_deepseek_serving(torch, card: str) -> dict:
    """deepseek-v3-671b at full widths, 4 of 61 layers: MLA, cold-started from
    a raw checkpoint the port saves."""
    return _moe_serving(torch, "deepseek_v3_671b", cold_start=True, card=card)


# ----------------------------------------------------------- phases 20-21
#: the moe family's training cut: the serving depth (MOE_LAYERS) with 64 of the
#: routed experts (384 and 256 published), everything else at full width. One
#: MoE layer's experts alone need 102 GB (kimi) and 68 GB (deepseek) of states
#: at ~6.06 B a parameter (bf16 parameters and gradients, int8 moments and
#: their f32 block scales): PERF.md §4
MOE_TRAIN_EXPERTS = 64
MOE_TRAIN_STEPS = 4
#: AdamW's rate (AdamWConfig's default), warmed up over 2 steps
MOE_TRAIN_LR = 3e-4
#: the reference's train_4k row (src/repro/launch/shapes.py:33) at batch 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 4096
#: the peak device memory PERF.md §6 predicted for each phase, printed beside the reading
MOE_TRAIN_PEAK_PREDICTED_GB = {"kimi_k2_1t": 58, "deepseek_v3_671b": 68}
#: the first-step gates' plain attention takes q heads a call within this many
#: bytes of scores, beside the model and its gradients
GATE_PLAIN_BYTES = 2 ** 30


@contextlib.contextmanager
def _expert_loads(loads: list):
    """Each MoE routing call's tokens and per-expert route counts (on the
    card), appended to ``loads``, for the share of routes dropped."""
    import torch

    from repro_torch.models import moe

    kept = moe.route

    def route(p, x2d, cfg):
        idx, gates, aux = kept(p, x2d, cfg)
        loads.append((x2d.shape[0], torch.bincount(idx.detach().flatten(),
                                                   minlength=cfg.moe.n_experts)))
        return idx, gates, aux

    moe.route = route
    try:
        yield
    finally:
        moe.route = kept


def _dropped_share(loads: list, cfg) -> dict:
    """Routes past their expert's capacity C = ceil(T·K/E · capacity factor)
    over the recorded calls (under remat a layer's routing runs again in the
    backward, on the same inputs: the share is the forward's)."""
    import math

    m = cfg.moe
    routes = dropped = 0
    for T, counts in loads:
        C = max(1, int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor)))
        dropped += int((counts - C).clamp_min(0).sum())
        routes += T * m.top_k
    return {"routing_calls": len(loads), "routes": routes, "dropped": dropped,
            "share": dropped / routes if routes else None}


@contextlib.contextmanager
def _attention_launches_by_width(kinds: dict):
    """The flash forward and backward launches (their wrappers' own counts)
    by (q·k, v) width pair."""
    from repro_torch.kernels import flash_attention as fa

    kept_fwd, kept_bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def add(key, n):
        kinds[key] = kinds.get(key, 0) + n

    def fwd(q, k, v, **kw):
        before = fa.launches
        got = kept_fwd(q, k, v, **kw)
        add(f"forward {q.shape[-1]}x{v.shape[-1]}", fa.launches - before)
        return got

    def bwd(q, k, v, *args, **kw):
        before = fa.bwd_launches
        got = kept_bwd(q, k, v, *args, **kw)
        add(f"backward {q.shape[-1]}x{v.shape[-1]}", fa.bwd_launches - before)
        return got

    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = kept_fwd, kept_bwd


def _stale_moments(torch, state) -> int:
    """Entries of the int8 moments whose first moment survived quantization
    and whose second did not (m != 0, v = 0): where the next gradient is
    exactly zero (an embedding row, an expert that the batch does not
    reach), the reference's update moves them by ~lr·m/eps (ROADMAP.md §3,
    fault 10). Counted a slice of 2^28 entries at a time."""
    n = 0

    def walk(m, v):
        nonlocal n
        if isinstance(m, dict) and "q" in m and isinstance(m["q"], torch.Tensor):
            mq, vq = m["q"].flatten(), v["q"].flatten()
            for lo in range(0, mq.numel(), 1 << 28):
                n += int(((mq[lo:lo + (1 << 28)] != 0) & (vq[lo:lo + (1 << 28)] == 0)).sum())
        elif isinstance(m, dict):
            for k in m:
                walk(m[k], v[k])

    walk(state["m"], state["v"])
    return n


def _largest_entries(torch, params, k: int = 3) -> dict:
    """The ``k`` parameter leaves with the largest max |entry|, and those."""
    from repro_torch.checkpoint.store import flatten

    top = sorted(((float(t.detach().abs().max()), n) for n, t in flatten(params, "param").items()),
                 reverse=True)[:k]
    return {n: v for v, n in top}


def _first_steps_bit_equal(torch, model, batch) -> dict:
    """Two first steps (forward and backward) of ``model`` on ``batch``:
    every gradient leaf bit-equal (the first step's kept on the host), and
    the losses equal. The model's gradients are freed."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.distributed import optimizer as optim

    runs = []
    for i in range(2):
        loss, _ = model.train_loss(batch)
        loss.backward()
        grads = flatten(model.param_tree(), "param")
        if i == 0:
            kept = {n: p.grad.to("cpu") for n, p in grads.items()}
            differ = []
        else:
            differ = [n for n, p in grads.items()
                      if not torch.equal(p.grad, kept[n].to(p.grad.device))]
        runs.append(float(loss.detach()))
        for p in optim.leaves(model.param_tree()):
            p.grad = None
    del kept
    return {"leaves": len(grads), "losses": runs, "differing_leaves": differ,
            "bit_equal": not differ and runs[0] == runs[1]}


def _moe_training(torch, arch: str, card: str) -> dict:
    """One moe config at full width, cut to its serving depth
    (``MOE_LAYERS``) and ``MOE_TRAIN_EXPERTS`` routed experts, bf16, random
    weights from seed 0 built on the card and tempered; 2 × 4,096 tokens
    (``data.synth.markov_tokens``) a batch from a RawArray token dataset
    through ``DeviceLoader``. The first step's gates against the same
    forward with the plain backward (``_first_step_gates``), two first steps
    bit-equal, then ``MOE_TRAIN_STEPS`` steps of the train loop's
    ``make_step`` with AdamW at the config's int8 moments (no checkpoint),
    and a profiled step. The line it prints names the card and its power
    limit (``card``)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed import optimizer as optim
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step

    dev = torch.device("cuda", 0)
    full = get_config(arch)
    cfg = full.with_(n_layers=MOE_LAYERS[arch],
                     moe=dataclasses.replace(full.moe, n_experts=MOE_TRAIN_EXPERTS))
    m = cfg.moe
    B, S, steps, L = MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS, cfg.n_layers
    out: dict = {"arch": cfg.name, "layers": L, "of_layers": full.n_layers,
                 "dense_layers": m.first_dense, "moe_layers": L - m.first_dense,
                 "experts": m.n_experts, "of_experts": full.moe.n_experts, "top_k": m.top_k,
                 "shared_experts": m.n_shared, "d_ff_expert": m.d_ff_expert,
                 "capacity_factor": m.capacity_factor, "dispatch_chunks": m.dispatch_chunks,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "attn_type": cfg.attn_type, "mtp": cfg.mtp, "vocab": cfg.vocab,
                 "dtype": cfg.param_dtype, "moments": cfg.opt_moment_dtype, "remat": cfg.remat,
                 "batch": B, "seq": S, "steps": steps, "card": card,
                 "peak_predicted_gb": MOE_TRAIN_PEAK_PREDICTED_GB[arch]}
    if cfg.attn_type == "mla":
        ml = cfg.mla
        out["widths"] = [ml.qk_nope_head_dim + ml.qk_rope_head_dim, ml.v_head_dim]
    else:
        out["widths"] = [cfg.head_dim, cfg.head_dim]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    _temper_attention(torch, model)
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    adamw = AdamWConfig(lr=MOE_TRAIN_LR, warmup_steps=2, moment_dtype=cfg.opt_moment_dtype)
    n_attn = L + int(cfg.mtp)  # attention calls a forward: the layers and the MTP layer
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{arch}_train_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=16, seq_len=S, vocab=cfg.vocab, seed=8, shard_rows=16)
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        heads = _plain_heads(B, cfg.n_heads, cfg.n_heads if cfg.attn_type == "mla"
                             else cfg.n_kv_heads, S, S, GATE_PLAIN_BYTES)
        out["first_step"] = _first_step_gates(torch, model, batch, arch, out,
                                              reference="plain backward", heads=heads)
        out["first_step"]["plain_heads_per_call"] = heads
        torch.cuda.empty_cache()
        out["repeat"] = _first_steps_bit_equal(torch, model, batch)
        log(f"[{arch} training] two first steps {json.dumps(out['repeat'])}")
        if not out["repeat"]["bit_equal"]:
            raise SystemExit(f"chip_smoke: {arch}'s two first steps differ: {out['repeat']}")
        torch.cuda.empty_cache()

        params = model.param_tree()
        state = optim.init_state(params, adamw)
        step_fn = make_step(model, adamw)
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        loads, widths = [], {}
        losses, step_s, metrics_seen, after = [], [], [], []
        try:
            with _expert_loads(loads), _attention_launches_by_width(widths):
                for _ in range(steps):
                    feed_batch = next(feed)
                    feed_batch.pop("_state", None)
                    t0 = time.perf_counter()
                    params, state, metrics = step_fn(params, state, feed_batch)
                    losses.append(float(metrics["loss"]))
                    step_s.append(time.perf_counter() - t0)
                    metrics_seen.append({k: float(metrics[k]) for k in
                                         ("ce", "aux", "acc", "mtp", "grad_norm", "lr")
                                         if k in metrics})
                    # outside the timed step: the int8 moments' stale entries and the
                    # parameters' largest entries, which show what the next step moves
                    after.append({"stale_moment_entries": _stale_moments(torch, state),
                                  "largest_entries": _largest_entries(torch, params)})
        finally:
            feed.stop()
        torch.cuda.synchronize()
    launches = {**_flash_counts(), "flash_attention_tc": flash_attention.tc_launches}
    step = statistics.median(step_s[1:])
    peak = torch.cuda.max_memory_allocated(dev)
    row = {"steps": steps, "losses": losses, "metrics": metrics_seen, "after_step": after,
           "step_s": step_s, "first_update_lowers_the_loss": losses[1] < losses[0],
           "loss_falls_over_the_steps": losses[-1] < losses[0],
           "median_step_s": step, "tokens_per_s": B * S / step,
           "peak_device_bytes": peak, "peak_device_gb": peak / 1e9,
           "routes_dropped": _dropped_share(loads, cfg), "launches": launches,
           "launches_by_width": widths,
           "want_launches": {"forward": (L * (2 if cfg.remat else 1) + int(cfg.mtp)) * steps,
                             "backward": n_attn * steps}}
    out["train"] = row
    log(f"[{arch} training] steps {json.dumps(row)}")
    # the first update is exact f32 AdamW in both packages (the moments are
    # quantized after it); from the second on, the reference's int8 moments move
    # an entry whose gradient vanished by ~lr·m/eps (fault 10), so over 4 steps
    # the loss is read, not gated
    if not all(np.isfinite(losses)) or not row["first_update_lowers_the_loss"]:
        raise SystemExit(f"chip_smoke: {arch} training: losses {losses}")
    if {k: launches[k] for k in ("forward", "backward")} != row["want_launches"] or \
            launches["flash_attention_tc"] != launches["forward"]:
        raise SystemExit(f"chip_smoke: {arch} training launched {launches}, wanted "
                         f"{row['want_launches']}, every forward on the tensor cores")
    del state, params
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch)
    del model
    torch.cuda.empty_cache()
    log(f"[{arch} training] {json.dumps(out)}")
    return out


def phase_kimi_training(torch, card: str) -> dict:
    """kimi-k2-1t-a32b trained at full widths, 2 of 61 layers and 64 of 384
    routed experts: GQA at head width 112."""
    return _moe_training(torch, "kimi_k2_1t", card)


def phase_deepseek_training(torch, card: str) -> dict:
    """deepseek-v3-671b trained at full widths, 4 of 61 layers (and the MTP
    layer) and 64 of 256 routed experts: MLA at (192, 128)."""
    return _moe_training(torch, "deepseek_v3_671b", card)


# --------------------------------------------------------------- phases 22-23
SSM_TRAIN_STEPS, SSM_RESUME_AT = 4, 2
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 2048


def _ssm_training(torch, arch: str, card: str) -> dict:
    """One ssm or hybrid config at full size (nothing cut but the steps),
    bf16, remat, random weights from seed 0 on the card (Zamba2's shared
    attention tempered as in phase 5), 4 × 2,048 tokens a batch from a
    RawArray token dataset through ``DeviceLoader``, the config's f32 AdamW
    moments: the first step's gates against the same forward kernels with the
    scan's plain backward (``_first_step_gates``), two first steps bit-equal
    leaf by leaf, ``train()`` for ``SSM_TRAIN_STEPS`` with a checkpoint at
    ``SSM_RESUME_AT`` and a second ``train()`` resumed there (within the
    resume gate), launch counts, and a profiled step. The line it prints
    names the card and its power limit (``card``)."""
    import shutil

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import build_model
    from repro_torch.train import TrainLoopConfig, train

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    s = cfg.ssm
    B, S, steps, L = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS, cfg.n_layers
    out: dict = {"arch": cfg.name, "family": cfg.family, "layers": L, "d_model": cfg.d_model,
                 "ssm_heads": cfg.n_ssm_heads, "headdim": s.headdim, "d_state": s.d_state,
                 "chunk": s.chunk, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
                 "moments": cfg.opt_moment_dtype, "remat": cfg.remat, "batch": B, "seq": S,
                 "steps": steps, "resume_at": SSM_RESUME_AT, "card": card}
    model = build_model(cfg, device=dev, seed=SEED)
    n_inv = len(getattr(model, "invocations", ()))
    if n_inv:
        _temper_attention(torch, model)
        out["shared_invocations"] = n_inv
        out["shared_head_dim"] = model.attn_cfg.head_dim
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    adamw = AdamWConfig(lr=1e-3, warmup_steps=2, moment_dtype=cfg.opt_moment_dtype)
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{arch}_train_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=8 * B, seq_len=S, vocab=cfg.vocab, seed=9,
                           shard_rows=8 * B)
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["first_step"] = _first_step_gates(torch, model, batch, arch, out,
                                              reference="plain scan backward")
        torch.cuda.empty_cache()
        out["repeat"] = _first_steps_bit_equal(torch, model, batch)
        log(f"[{arch} training] two first steps {json.dumps(out['repeat'])}")
        if not out["repeat"]["bit_equal"]:
            raise SystemExit(f"chip_smoke: {arch}'s two first steps differ: {out['repeat']}")
        torch.cuda.empty_cache()

        def run(ckpt_dir, resume):
            feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                                device=dev)
            return train(model, feed, TrainLoopConfig(
                steps=steps, ckpt_every=SSM_RESUME_AT, ckpt_dir=ckpt_dir, log_every=1,
                adamw=adamw), resume=resume)

        def counts():
            return {"ssd_scan": ssd.launches, "ssd_scan_tc": ssd.tc_launches,
                    "ssd_scan_bwd": ssd.bwd_launches, "ssd_scan_bwd_tc": ssd.bwd_tc_launches,
                    **_flash_counts()}

        def reset():
            ssd.launches = ssd.tc_launches = ssd.bwd_launches = ssd.bwd_tc_launches = 0
            _reset_flash_counts()

        ckpt = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        res = run(ckpt, resume=False)
        torch.cuda.synchronize()
        launches = counts()
        # step s: the median of the steps after the first (which warms the
        # allocator) but the one after the checkpoint (which waits for its host
        # snapshot); tokens/s from it
        timed = [t for i, t in enumerate(res["step_s"]) if i not in (0, SSM_RESUME_AT)]
        peak = torch.cuda.max_memory_allocated(dev)
        row = {"losses": res["losses"], "step_s": res["step_s"],
               "median_step_s": statistics.median(timed),
               "tokens_per_s": B * S / statistics.median(timed),
               "peak_device_bytes": peak, "peak_device_gb": peak / 1e9}
        row["ckpt_save_s"] = res["ckpt_save_s"]
        row["launches"] = launches
        mult = 2 if cfg.remat else 1
        row["want_launches"] = {"ssd_scan": L * steps * mult, "ssd_scan_tc": L * steps * mult,
                                "ssd_scan_bwd": L * steps, "ssd_scan_bwd_tc": L * steps,
                                "forward": n_inv * steps, "backward": n_inv * steps}
        out["train"] = row
        log(f"[{arch} training] steps {json.dumps(row)}")
        if not all(np.isfinite(res["losses"])) or res["losses"][-1] >= res["losses"][0]:
            raise SystemExit(f"chip_smoke: {arch} training: losses {res['losses']}")
        if launches != row["want_launches"]:
            raise SystemExit(f"chip_smoke: {arch} training launched {launches}, wanted "
                             f"{row['want_launches']}")

        # a second train() from the checkpoint at SSM_RESUME_AT (hard links in a
        # directory of its own) for the last steps: within the resume gate
        straight = res["losses"]
        path = os.path.join(ckpt, f"step_{SSM_RESUME_AT:08d}")
        saved = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        del res
        torch.cuda.empty_cache()
        again = os.path.join(tmp, "resume")
        shutil.copytree(path, os.path.join(again, f"step_{SSM_RESUME_AT:08d}"),
                        copy_function=os.link)
        reset()
        with _tee_stdout() as printed:
            res = run(again, resume=True)
        torch.cuda.synchronize()
        resumed = {"losses": res["losses"], "straight_losses": straight[SSM_RESUME_AT:],
                   "checkpoint_bytes": saved,
                   "cold_start": _cold(res["cold_start"]) if res["cold_start"] else None,
                   "launches": counts(),
                   "bit_equal": res["losses"] == straight[SSM_RESUME_AT:]}
        out["resume"] = resumed
        del res
        log(f"[{arch} training] resume {json.dumps(resumed)}")
        if f"resumed from step {SSM_RESUME_AT}" not in printed.getvalue() or \
                len(resumed["losses"]) != steps - SSM_RESUME_AT or \
                not np.allclose(resumed["losses"], straight[SSM_RESUME_AT:], rtol=1e-5,
                                atol=1e-6):
            raise SystemExit(f"chip_smoke: the {arch} resume differs: {resumed}")
        bwd = resumed["launches"]
        if bwd["ssd_scan_bwd"] != L * (steps - SSM_RESUME_AT) or \
                bwd["ssd_scan_bwd_tc"] != bwd["ssd_scan_bwd"]:
            raise SystemExit(f"chip_smoke: the {arch} resume's scan backward did not run "
                             f"{L} tensor-core launches a step: {bwd}")
    torch.cuda.empty_cache()
    kinds = ("scan forward", "scan backward") + (
        ("attention forward", "attention backward") if n_inv else ())
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch, require=kinds)
    del model
    torch.cuda.empty_cache()
    log(f"[{arch} training] {json.dumps(out)}")
    return out


def phase_mamba2_training(torch, card: str) -> dict:
    """Mamba2-780M trained at full size: 48 Mamba2 layers, the scan's forward
    and backward kernels at P 64, N 128."""
    return _ssm_training(torch, "mamba2_780m", card)


def phase_zamba2_training(torch, card: str) -> dict:
    """Zamba2-1.2B trained at full size: 38 Mamba2 layers at N 64 and the
    shared block 6 times, its attention at (128, 128), group 1."""
    return _ssm_training(torch, "zamba2_1_2b", card)


def _float32(torch, tree):
    """A copy of a nested dict of tensors with the float leaves in float32."""
    if isinstance(tree, dict):
        return {k: _float32(torch, v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _cold(st) -> dict:
    return {"seconds": st.restore_s, "leaves": st.leaves, "logical_bytes": st.logical_bytes,
            "stored_bytes": st.stored_bytes, "logical_gb_per_s": st.logical_bytes / st.restore_s / 1e9,
            "stored_gb_per_s": st.stored_bytes / st.restore_s / 1e9, "h2d_s": st.h2d_s,
            "peak_inflight_bytes": st.peak_inflight_bytes}


# --------------------------------------------------------------- main
def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    t_start = time.perf_counter()
    card = phase_environment(torch)
    # phase 4's CIFAR-10-shaped dataset and phase 5's checkpoints stay here
    # for phase 12, which serves them by URL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as keep:
        return _phases(torch, card, keep, t_start)


def _phases(torch, card: str, keep: str, t_start: float) -> int:
    phase_s: dict = {}  # each phase's wall seconds, printed with the total

    def run(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        return out

    build_s = run(phase_build)
    sass = run(phase_sass)
    rows = run(phase_kernels, torch)
    flash_rows, decode_rows = run(phase_attention, torch)
    ssd_rows = run(phase_ssd, torch)
    ssd_bwd_rows = run(phase_ssd_bwd, torch)
    bwd_rows = run(phase_attention_bwd, torch)
    runs = run(phase_main_path, torch, keep)
    serve = run(phase_serving, torch, keep)
    ssm = run(phase_ssm_serving, torch)
    gemma = run(phase_gemma3_serving, torch)
    small = run(phase_paper_lm_training, torch)
    big = run(phase_internlm2_training, torch)
    g_train = run(phase_gemma3_training, torch)
    zamba = run(phase_zamba2_serving, torch)
    rem = run(phase_remote, torch, keep, serve, runs)
    mesh = run(phase_data_mesh, torch, keep, runs)
    llava = run(phase_llava_serving, torch)
    whisper = run(phase_whisper_serving, torch)
    w_train = run(phase_whisper_training, torch)
    l_train = run(phase_llava_training, torch)
    kimi = run(phase_kimi_serving, torch, card)
    deepseek = run(phase_deepseek_serving, torch, card)
    k_train = run(phase_kimi_training, torch, card)
    d_train = run(phase_deepseek_training, torch, card)
    m_train = run(phase_mamba2_training, torch, card)
    z_train = run(phase_zamba2_training, torch, card)

    main_row = rows[0]  # the CIFAR batch: the shape every epoch batch of the feed has
    feed_launches = {r["name"]: r["launches"] for r in runs}
    kernels = [{
        "name": "dequant_u8",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_u8.cu",
        "replaces": "src/repro/kernels/dequant_u8.py:31",
        "launches": sum(feed_launches.values()) + serve["u8_cold_start"]["dequant_launches"]
        + rem["u8_url"]["dequant_launches"] + rem["feed_url"]["launches"]
        + mesh["global_feed"]["launches"] + mesh["four_hosts"]["launches"]
        + mesh["restore"]["u8"]["unsharded"]["dequant_launches"]
        + w_train["train"]["launches"]["dequant_u8"] + l_train["train"]["launches"]["dequant_u8"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tolerance": 0.0,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "library_call": "torch.addcmul(bias, x_uint8, scale)",
        "exact": all(r["exact"] for r in rows),
        "build_s": build_s,
        "shapes": rows,
        "main_path_launches": {**feed_launches,
                               "u8_cold_start": serve["u8_cold_start"]["dequant_launches"],
                               "u8_url_cold_start": rem["u8_url"]["dequant_launches"],
                               "cifar10_epoch_url": rem["feed_url"]["launches"],
                               "cifar10_epoch_mesh": mesh["global_feed"]["launches"],
                               "cifar10_mesh_4_hosts": mesh["four_hosts"]["launches"],
                               "u8_cold_start_beside_mesh":
                                   mesh["restore"]["u8"]["unsharded"]["dequant_launches"],
                               f"{w_train['arch']} train frames":
                                   w_train["train"]["launches"]["dequant_u8"],
                               f"{l_train['arch']} train patch_embeds":
                                   l_train["train"]["launches"]["dequant_u8"]},
    }]
    def by_phase(key):
        return {serve["arch"]: serve[key], gemma["arch"]: gemma[key],
                f"{rem['arch']} from the URL": rem["serve_url"][key], llava["arch"]: llava[key],
                f"{kimi['arch']} ({kimi['layers']} layers)": kimi[key],
                f"{deepseek['arch']} ({deepseek['layers']} layers)": deepseek[key]}

    llava_prefills = {f"{llava['arch']} prefill {r['batch']} x ({r['patches']} + {r['tokens']})":
                      r["launches"] for r in llava["prefill"]}
    whisper_kinds = {f"{whisper['arch']} {kind}": n
                     for kind, n in whisper["launches_by_kind"].items()}

    def train_launches(kind):
        runs = {f"{small['arch']} train ({name})": row["launches"][kind]
                for name, row in small["runs"].items()}
        runs[f"{big['arch']} train"] = big["train"]["launches"][kind]
        runs[f"{g_train['arch']} train"] = g_train["train"]["launches"][kind]
        runs[f"{w_train['arch']} train"] = w_train["train"]["launches"][kind]
        runs[f"{w_train['arch']} train (resumed)"] = w_train["resume"]["launches"][kind]
        runs[f"{l_train['arch']} train ({l_train['layers']} layers)"] = \
            l_train["train"]["launches"][kind]
        for how in ("flags", "env"):
            runs[f"{small['arch']} mesh train ({how})"] = mesh["training"][how]["launches"][kind]
        for t in (k_train, d_train):
            runs[f"{t['arch']} train ({t['layers']} layers, {t['experts']} experts)"] = \
                t["train"]["launches"][kind]
        runs[f"{z_train['arch']} train"] = z_train["train"]["launches"][kind]
        runs[f"{z_train['arch']} train (resumed)"] = z_train["resume"]["launches"][kind]
        return runs

    def ssm_train_launches(key):
        return {f"{t['arch']} train{how}": row["launches"][key]
                for t in (m_train, z_train)
                for how, row in (("", t["train"]), (" (resumed)", t["resume"]))}

    zamba_prefill = f"{zamba['arch']} prefill"
    for name, replaces, rows_, launches, call in (
        ("flash_attention", "src/repro/kernels/flash_attention.py:66", flash_rows,
         {**by_phase("flash_attention_launches"), **train_launches("forward"),
          zamba_prefill: zamba["prefill_launches"]["flash_attention"],
          **{k: v["flash_attention"] for k, v in llava_prefills.items()},
          **{k: v for k, v in whisper_kinds.items() if not k.endswith("decode")}},
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, "
         "enable_gqa=True)"),
        ("decode_attention", "src/repro/kernels/decode_attention.py:61", decode_rows,
         {**by_phase("decode_attention_launches"),
          zamba["arch"]: zamba["decode_attention_launches"],
          **{k: v for k, v in whisper_kinds.items() if k.endswith("decode")}},
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=kpos <= pos, "
         "enable_gqa=True)"),
        ("ssd_scan", "src/repro/kernels/ssd_scan.py:68", ssd_rows,
         {ssm["arch"]: ssm["ssd_scan_launches"],
          zamba_prefill: zamba["prefill_launches"]["ssd_scan"],
          **ssm_train_launches("ssd_scan")}, None),
    ):
        main = rows_[0]  # the shape the serving path gives the kernel
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(launches.values()),
            "main_path_launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "tolerance": main["tolerance"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": call,
            "shapes": rows_,
        })
        kernels[-1]["sass"] = sass[f"{name}.cu"]
        if name == "flash_attention":
            kernels[-1]["tc_launches"] = sum(by_phase("flash_attention_tc_launches").values()) \
                + zamba["prefill_launches"]["flash_attention_tc"] \
                + sum(v["flash_attention_tc"] for v in llava_prefills.values()) \
                + whisper["launches"]["flash_attention_tc"]
        if name == "ssd_scan":
            kernels[-1]["tc_launches"] = ssm["ssd_scan_tc_launches"] \
                + zamba["prefill_launches"]["ssd_scan_tc"] \
                + sum(ssm_train_launches("ssd_scan_tc").values())
    main = bwd_rows[0]  # paper_lm's training shape: the north star's train step
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:66 (its gradient, which the JAX "
                    "train step leaves to XLA: src/repro/train/loop.py:61)",
        "launches": sum(train_launches("backward").values()),
        "main_path_launches": train_launches("backward"),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "tolerance": main["tolerance"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.autograd.grad of torch.nn.functional.scaled_dot_product_attention"
                        "(q, k, v, is_causal=True), K/V repeated over the group",
        "shapes": bwd_rows,
        "sass": sass["flash_attention_bwd.cu"],
    })
    main = ssd_bwd_rows[0]  # Mamba2-780M's training shape (phase 22)
    kernels.append({
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:68 (its gradient, which the JAX package "
                    "leaves to XLA through models/mamba.py:ssd_chunked)",
        "launches": sum(ssm_train_launches("ssd_scan_bwd").values()),
        "main_path_launches": ssm_train_launches("ssd_scan_bwd"),
        "max_abs_err": max(r["max_abs_err"] for r in ssd_bwd_rows),
        "tolerance": main["tolerance"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "library_call": None,
        "bit_equal": all(r["bit_equal"] for r in ssd_bwd_rows),
        "tc_launches": sum(ssm_train_launches("ssd_scan_bwd_tc").values()),
        "shapes": ssd_bwd_rows,
        "sass": sass["ssd_scan_bwd.cu"],
    })
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; by phase {json.dumps(phase_s)}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
