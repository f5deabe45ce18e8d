#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Drives the port's main paths — the fluid network simulator with the fused
netsim tick (``backend="cuda"``, ``tick_window=1``), with the multi-tick
window kernel (``tick_window > 1``), with the tiled tick
(``segsum="onehot"``, ``blk``) on the 512-host grid, the online controller,
the Alg. 1 switch pipeline, the serving path of h2o-danube-3-4b at full
width (a 32,768-token prefill through the flash attention kernel, then the
continuous-batching engine), its training path at full width (train_4k's
sequence through the flash forward and backward kernels, AdamW) and the
serving path of mamba2-130m at full width (8 x 32,768 tokens through the
SSD scan kernel, then the engine), the MoE family's on granite-moe-1b-a400m
at full width, the hybrid's on one period of jamba-v0.1-52b at full width,
the MLA, M-RoPE and encoder-decoder families' on minicpm3-4b, qwen2-vl-2b
and whisper-large-v3 at full width, the simulator's lanes split over
devices, the explicit ring collectives, ring-synced data-parallel training
of danube (full width, 2 layers), the MoE's expert-parallel dispatch and
GPipe over ranks on the card named several times, and the launch layer's
cells against the meta-tensor dry-run's memory and flop prediction —
phase by phase, one line per phase, and exits non-zero at the first phase
that fails:

1. build    compile every kernel library from the checkout (one nvcc per
            source, in parallel, sm_90a); print the card's name and power
            limit from nvidia-smi, each flash forward kernel's (bf16 and
            float32) and each bf16 flash backward kernel's registers, local
            (spill) bytes, shared memory and threads, and
            the tick and window kernels' registers, stack, spills and
            shared memory for both instantiations (link ids in shared or
            in global memory) and every SSD kernel's (each instantiation)
            from ptxas's report, and the tiled tick's five kernels' and
            the switch scan's; a spill fails
2. math     the window kernel's expf/log1pf against torch's CUDA exp/log1p
            over the ranges the tick feeds them (ulps reported)
3. kernel   the single-tick kernel against its plain torch version on the
            card, on mid-run states (300 eager ticks first) at the Table-1
            shape and the 128-host fat_tree_multipod shape (8 lanes),
            sym_on/pq_on on and off (as lanes) and per_step_ecmp on and off;
            per shape the most active instances and the longest link-row
            and Symphony-row segments of a tick (what the kernel's row
            sorts see), and per output the float elements whose bits
            differ from the plain version
4. window   the window kernel against its plain version (eager ticks) on
            the card from the same mid-run states: windows of 20 and 7
5. tiled    the tiled kernel against its plain version on mid-run states,
            bit for bit: Table 1 (blk=256, 4 lanes; also blk=300, a ragged
            last block, and 2048, one block), 128 hosts (blk=1024) and 512
            hosts (blk=2048), 8 lanes each; a planted fault (the row sort
            placing a batch's entries of one row in reverse) must differ
6. large    the tick and window kernels at 256 and 512 hosts (8 lanes),
            whose link ids live in global memory, against their plain
            versions: 3 ticks, windows of 20 and 7; active instances,
            longest segments and bit-differing elements as in kernel
7. switch   the switch-pipeline kernel against its plain version, bit for
            bit, on both marking paths: 8,000 packets; the edge traces of
            ref.scan_traces at the kernel's tile; a 17,825,792-packet trace
            whose counts pass 2^24 (closed-form states); then the entry
            point on a 1,000,000-packet trace (its main path, launches
            counted), all of it against the plain version; two planted
            faults (a look-back that skips the nearest tile, counts
            without saturation) must fail
8. flash    the flash attention kernel against its plain version in bf16
            and float32: the reference's five FLASH_CASES and danube's head
            layout (32 query heads, 8 KV heads, D 120) at S = 4,096 with
            windows 1,024 and 8,192, each as [BH, S, D] tensors and as
            strided [B, H, S, D] views of [B, S, H, D] activations; then
            the prefill's shape (S = 32,768, window 8,192, bf16) on N(0,1)
            inputs against the chunked plain version, and six planted
            faults that must fail the same check; every shape launched
            twice, bit-equal; also the heads of minicpm3 (40/40, D 96), of
            qwen2-vl (12/2, D 128) at S 4,096 and of whisper (20/20, D 64,
            B 16, S 384), causal
9. flash_bwd the flash backward kernels (dq, dk/dv) against the plain
            backward computed in float32 on the same values, in bf16 and
            float32, as [BH, S, D] tensors and as strided [B, H, S, D]
            views: the five FLASH_CASES and the training shape (B 2, heads
            32/8, S 4,096, D 120) with danube's window (8,192) and with
            1,024; each row held to ROW_TOL, float32 also to the reference's
            5e-4, two launches bit-equal; then six planted faults that must
            fail the same check
10. prefill h2o-danube-3-4b at full width (24 layers, d_model 3,840, bf16
            weights drawn on the card from seed 0), build_model(cfg,
            use_flash=True): one prefill of 1 x 32,768 tokens (24 flash
            launches counted), layer 0's attention through the kernel
            against the chunked plain attention, and the whole prefill
            again without the kernel (last-token logits compared: at this
            init a check that the path runs, not of attention)
11. serve   the same model behind ServeEngine (8 slots, 4,096 positions):
            12 requests of 32-96 prompt tokens, 32 new tokens each, drained
            with slots refilled; a 256-token prompt's decode against its
            prefill, and layer 0's attention over decode's cache against
            the kernel at its last token
12. train   the same model trained (remat per block, AdamW with float32
            m/v and master weights: danube's ARCH_POLICY) on SyntheticLM
            batches of 2 x 4,096 tokens: one step's gradients through the
            flash kernels against the plain path's, per leaf; a warm-up
            step (lr 0: every parameter unchanged) and 6 steps of
            make_train_step whose flash launches are counted (24 forward,
            24 recompute, 24 dq, 24 dk/dv a step), finite losses, tokens/s
            and peak memory; then the smoke-width Trainer on the card: the
            loss falls over 30 steps, a checkpoint restart replays the
            straight run, an injected failure recovers
13. ssd     the SSD scan kernels (one call: prefix sums, chunk states,
            the ordered state pass, outputs) against their plain version on
            the card
            (y and the final state at the reference's 5e-4): the
            reference's four SSD_CASES (ragged S 200 included) with float32
            and with bf16 B/C, through ops.ssd's strided views and on
            contiguous [B, H, S, P] copies; the main shape (B 8, H 24, S 32,768, P 64,
            N 128, chunk 128, bf16 B/C); layer 0's own inputs captured from
            a full-width mamba2 prefill; each launched twice, bit-equal;
            then five planted faults that must fail the same check
14. mamba   mamba2-130m at full width (24 layers, d_model 768, bf16
            weights drawn on the card from seed 0; param_count checked),
            build_model(cfg, use_ssd_kernel=True): one prefill of 8 x
            32,768 tokens (24 SSD launches counted) against the plain path's
            last-token logits, a 256-token prompt decoded token by token
            against its prefill (both also in float32, where a prefill with
            a planted scan fault must fail), and 12 requests drained
            through ServeEngine (8 slots, 4,096 positions), slot 0 against
            a 1-slot replay of the tokens it was fed
15. moe     granite-moe-1b-a400m at full width (24 layers, d_model 1,024,
            16/8 heads of 64, 32 experts top-8 of d_ff 512; bf16 weights
            drawn on the card from seed 0; param_count checked),
            build_model(cfg, use_flash=True): one prefill of 8 x 32,768
            tokens (24 flash launches counted; the assignments each layer
            drops at capacity reported), layer 0's attention through the
            kernel against the chunked plain attention, layer 0's MoE run
            twice on its own input (bit-equal), the prefill again without
            the kernel (last-token logits at the model tolerance), a
            256-token prompt decoded token by token against its prefill
            (compared when the prefill dropped nothing), and 12 requests
            of 16-48 prompt tokens drained through ServeEngine (8 slots,
            4,096 positions)
16. jamba   jamba-v0.1-52b at full width cut to one period (8 of 32
            layers: 7 SSM, 1 attention, MoE on the odd ones; 13.0 B bf16
            parameters drawn on the card from seed 0),
            build_model(cfg, use_flash=True, use_ssd_kernel=True): one
            prefill of 1 x 32,768 tokens (7 SSD calls and 1 flash launch
            counted) against the plain path's last-token logits, layer 0's
            own scan inputs through the kernel against the plain scan, a
            256-token prompt decoded against its prefill, 12 requests
            drained through ServeEngine; the model is freed after
17. mla     minicpm3-4b at full width cut to 31 of 62 layers (d_model
            2,560, 40 heads, MLA ranks 768/256, qk 64 + 32, v 64; 2.13 B
            bf16 parameters
            drawn on the card from seed 0; param_count checked),
            build_model(cfg, use_flash=True): one prefill of 1 x 32,768
            tokens (31 flash launches counted at D 96: V padded 64 -> 96),
            the attention of minicpm3's layout (shared rope key, padded V)
            through the kernel against the chunked plain attention on
            N(0,1) inputs at that length, the last-token logits of a 1 x
            4,096 prefill against the plain path's, a 256-token prompt's
            absorbed decode (latent caches) against its prefill at the
            reference's MLA tolerance, and 8 requests of 16-48 prompt
            tokens, 16 new each, drained through ServeEngine (8 slots,
            4,096 positions); the model is freed after
18. vlm     qwen2-vl-2b at full width (28 layers, d_model 1,536, 12/2 heads
            of 128, M-RoPE sections 16/24/24, theta 1e6; 1.54 B): one
            prefill of stub patch embeddings [1, 32,768, 1,536] with (t, h,
            w) positions [1, S, 3] (t = arange, h and w a grid's rows and
            columns) through 28 flash launches at D 128, group 6; the
            kernel against the chunked plain attention on N(0,1) inputs
            at that shape; the last-token logits of a 1 x 4,096 prefill
            against the plain path's (t = arange: both compute the same
            function); a 256-token text prompt decoded against its
            prefill; minicpm3's serving cell on text tokens; freed after
19. whisper whisper-large-v3 at full width (32 + 32 layers, d_model 1,280,
            20 heads of 64, layernorm, GELU, vocab 51,866; 1.54 B): 16 x
            1,500 encoder frames (N(0,1) stub embeddings, 30 s of audio)
            and a teacher-forced decoder of 384 tokens (32 flash launches
            counted at D 64, S 384; the encoder and cross attention stay
            plain, as in the reference), every logit against the plain
            path's (held as mamba's logits are: the input token's logit to
            ECHO_RTOL, the rest of each row to BF16_REL_L2, every argmax);
            a greedy decode of 64 steps through init_cache / decode_step
            held so to the teacher-forced logits of the same tokens; freed
            after
20. multipod 128-host fat_tree_multipod, 8 seeds as lanes, 2,000 ticks:
            backend="cuda" with tick_window 1 and 20 (the main-path runs
            whose launches are counted) against backend="eager"
21. lanes   the grid entry points' devices=: the same 8 lanes over the card
            named 2 and 3 times (tick_window 1, cut to 500 ticks, and
            20), and Table 1's four
            knob points with chunk_knobs=1 over 2 entries (goldens
            checked), each against the one-device run (integer series bit
            for bit, float series allclose, bit-differing elements
            counted; wall times beside each other); a planted fault (shares
            that renumber their lanes) must fail
22. ring    the explicit ring collectives over the card named 4 and 8
            times (a host thread and CUDA stream a rank): ring_all_reduce
            (plain, channels=2, bidirectional) and ring_all_reduce_nd over
            the reference test's sweep in float32 and bf16,
            ring_reduce_scatter + ring_all_gather, hierarchical_all_reduce
            on (pod 2, data 2) and (2, 4) with and without int8 compress,
            sync_grads_local in its three modes (bucket_bytes=64) and a
            256 MiB float32 all-reduce: every case bit-equal to the same
            call over CPU ranks, within the reference's tolerance of the
            plain sum, 2(N-1) ppermutes per ring per channel; two planted
            faults (a ring shifted by two, the last reduce-scatter step
            dropped) must fail; the 256 MiB all-reduce timed with CUDA
            events over 4 and 8 ranks beside one stack(...).sum(0)
23. dp      h2o-danube-3-4b at full width cut to 2 of 24 layers (432.6 M
            parameters; remat per block, ARCH_POLICY's AdamW, flash):
            step 0's ring-synced gradients on mesh (data 4) against one
            device's on the whole 4 x 4,096 batch (rel L2 2e-2 a leaf,
            losses 1e-2), then 3 grad_sync="ring" steps on (data 4) and 3
            "hierarchical" steps on (pod 2, data 2), the card named 4
            times: the four replicas bit-equal after every step, flash
            calls counted per rank (by its stream), ms a step, the sync's
            ms and peak memory
24. ep      granite-moe-1b-a400m's layer-0 moe_block at full width over
            (data 2, model 4), the card named 8 times (all_to_all over
            model), on 2 x 4,096 N(0,1) bf16 tokens: at capacity 8.0
            (nothing drops) against the one-device path at BF16_REL_L2;
            at granite's 1.25 two runs bit-equal, drops reported
25. gpipe   4 stages of one danube block each at full width over the card
            named 4 times, 4 microbatches of 1 x 4,096: GPipe's 7 ticks,
            each microbatch bit-equal to the 4 blocks applied in turn on
            one device
26. tp      tensor parallelism (GSPMD's partitioning of the dense GQA and
            MLA, MoE, SSM and hybrid families, ``models/lm.py``) over the
            card named 8 and 4 times:
            danube at full width cut to 2 of 24 layers on (data 2, model
            4), float32, a global batch of 4 x 4,096: one step of
            make_train_step with grad_sync "xla", then with FSDP, then
            "ring", each against one device's step on the same padded
            tree (gradients per leaf, loss, gradient norm, every leaf's
            update), its collectives by kind, ms, the sync's ms and peak
            memory; danube's 24 layers prefilling 1 x 32,768 tokens on
            (data 1, model 4) through the flash forward at a rank's shape
            (8 q heads, 2 KV heads a rank; launches per rank counted),
            last-token logits against the one-device flash route at the
            prefill phase's model tolerance, tokens/s and peak memory;
            granite-moe-1b-a400m likewise: 2 of 24 layers in float32 on
            (data 2, model 4), 4 x 4,096, capacity factor 2.0 (nothing
            drops, counted), grad_sync "xla" and "ring" against one
            device's step (its aux the ranks' mean), collectives by kind
            equal to the CPU ranks' derivation (all-to-all included), the
            tokens whose top-k differs from one device's and the smallest
            top-k probability gap per layer; 12 of its 24 layers
            prefilling 1 x 32,768 on (data 1, model 4) at its capacity 1.25
            against one device, each layer's drops on both sides; its
            layer-0 moe_block inside the ranks against the EP path
            outside a rank (capacity 1.25, and 1.0 where rows drop:
            bit-equal, the same drops); mamba2-130m's step likewise (2 of
            24 layers, float32, xla and ring, the plain scan on each
            rank's 6 heads) and its 24 layers prefilling 1 x 32,768 on
            (data 1, model 4) through the SSD kernel (96 calls, 24 a rank)
            in float32 (at the mamba phase's float32 tolerance) and in bf16
            (rows and argmax) against one device; jamba's first period
            (7 SSM and 1 attention layer) prefilling 1 x 32,768 in bf16 on
            (1, 4) through the flash and SSD kernels (4 and 28 calls)
            against the one-device route by rows and argmax, drops per MoE
            layer on both sides; jamba's layer 0 (SSM and MLP) in float32
            inside the ranks against one device; minicpm3-4b's step
            likewise (2 of 62 layers, float32, xla and ring, q_lora over
            model: 192 of 768 and 10 of 40 heads a rank, its collectives
            by kind with the q RMSNorm's psum and the q reduce-scatter
            equal to the CPU ranks' derivation) and 31 of its 62 layers
            prefilling 1 x 32,768 in bf16 on (data 1, model 4) through
            the flash forward (124 calls, 31 a rank) against one device
            by rows and argmax; the flash forward and backward kernels
            timed at a rank's shapes (danube's, granite's, jamba's and
            minicpm3's), the backward pair at granite's (D 64) and
            minicpm3's (D 96) and the forward at granite's, jamba's and
            minicpm3's held to the plain versions, the SSD kernel held to
            its plain version and timed at mamba2's and jamba's rank
            shapes
27. launch  the launch layer (``launch/steps.py``, ``launch/dryrun.py``):
            the dry-run's records (meta devices, in worker processes) of
            danube's and mamba2's four cells on both production meshes
            (GiB a device, TFLOP, the three roofline terms at the card's
            spec-sheet constants); then cells as build_cell builds them
            on the card, each beside its dry-run prediction (printed
            first): danube prefill_32k on one rank of a (data 32, model 1)
            mesh (1 x 32,768 tokens, 24 layers, bf16 weights drawn on the
            card from seed 0, plain chunked attention), FlopCounterMode's
            count equal to the meta count, peak memory within LAUNCH_BAND
            of argument + output - alias + temp, wall time and TFLOP/s
            against t_compute; the same model with use_flash (24 flash
            launches; last-token logits at the prefill phase's model
            tolerance); danube train_4k at depth 2 on one rank of (16, 1)
            (16 x 4,096 tokens, accum 2, float32 m/v and master; step 1:
            finite loss, every parameter moved, peak within the band);
            mamba2 decode_32k, the whole cell on a (1, 1) mesh of the card
            (batch 128; logits finite, the cache written in place, peak
            within the band); two planted faults of the decode prediction
            (donation ignored, the cache's bytes dropped) must fail the band;
            the card's total memory equal to the dry-run's HBM_BYTES; and
            one partitioned record held to the card: danube train_4k on one
            rank of (data 16, model 16) at depth 2, run alone
            (spmd.lone_rank) on real tensors, its flop count equal to the
            meta count and its peak within TP_LAUNCH_BAND (5 %); granite
            train_4k likewise (its all_to_alls keep their shapes alone),
            jamba train_4k at one period (8 of 32 layers) and minicpm3
            train_4k at depth 2; every meta
            run of the phase starts with the whole run in LAUNCH_WORKERS
            processes at nice 19
28. goldens Table 1, 20,000 ticks, seed 3: the ecmp_base and ecmp_sym golden
            finish ticks (two lanes of one grid run) through
            backend="cuda" with tick_window 1 (one tick launch per tick),
            20 (1,000 window launches) and 7 (3,000), and through the tiled
            tick with blk=256 (20,000 tiled launches); the two host-bound
            tick_window=1 runs (GOLDEN_EARLY) run in worker processes of
            their own, side by side, started when the launch phase starts
            (it measures no rate but under its flop counter), else when
            this phase does
29. grid512 the 512-host grid (16 pods; sym off/on x 4 seeds as lanes),
            1,000 ticks: the tiled tick (blk=2048, tick_window=1) and the
            window kernel (tick_window=20), their launches counted, against
            their plain versions on the card and against eager
30. control SimController on the card (Table 1, window_ticks=640,
            tick_window=20): stepping equals one-shot simulate, tau retuned
            mid-run, checkpoint/restore replays bit for bit
31. timing  each kernel's device time per launch against its plain
            version's and its bound, at the main paths' shapes (the flash
            forward also against one scaled_dot_product_attention call, at
            the prefill's shape with a window mask and at the training
            shape, B 2 x S 4,096, causal, and at granite's, jamba's,
            minicpm3's (D 96), qwen2-vl's (group 6) and whisper's (B 16,
            S 384) prefill shapes, causal;
            the backward kernels against one autograd.grad through it,
            also as the pair's sum over that call's time; the SSD kernels
            (also at jamba's shape, H 128, N 16) have no library
            counterpart: their bound in float32 on the CUDA
            cores and, beside it, on the tensor cores in TF32 per split
            pass; with ``--against DIR`` another commit's SSD scan, tiled
            tick and switch pipeline (the first port's interface or the
            shipped one, by each library's ``*_abi`` tag), timed in turns
            beside the shipped ones)
32. profile main-path ticks/s (Table 1 with 1 lane through ``simulate``,
            128 hosts x 8 lanes, 512 hosts x 8 lanes) and where a tick's
            time goes: wall and device-busy time, the busiest kernels; one
            profiled 32,768-token prefill: the flash kernel's, the matrix
            products' and the rest's share of device time; one profiled
            training step: flash forward, dq, dk/dv, matrix products, the
            optimizer and the rest; one profiled mamba2 prefill of 8 x
            32,768 tokens: the SSD kernels' (all four, by name), the matrix
            products' and the rest's share; one profiled granite prefill of
            8 x 32,768 tokens: flash, matrix products, the MoE dispatch
            (sorts, scatters, gathers, index copies) and the rest

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py build tiled  # a subset (no report lines)
    python3 chip_smoke.py build kernel window large   # tick and window
    python3 chip_smoke.py build flash_bwd train timing   # training path
    python3 chip_smoke.py build ssd mamba         # the SSM serving path
    python3 chip_smoke.py build moe jamba lanes   # MoE, hybrid, lanes
    python3 chip_smoke.py build flash mla vlm whisper timing
        # the MLA, M-RoPE and encoder-decoder families
    python3 chip_smoke.py build ring dp ep gpipe
        # collectives, data-parallel training, EP and GPipe over ranks
    python3 chip_smoke.py build tp launch
        # tensor parallelism and the partitioned dry-run record
    python3 chip_smoke.py build launch
        # the cells and the dry-run's prediction
    python3 chip_smoke.py --against DIR build ssd mamba timing
        # DIR: another commit's kernels, unpacked under a git-ignored
        # directory (git archive <commit> src/repro_torch/kernels | tar -x
        # -C DIR), or a directory holding its ssd.cu; timed beside these

It needs one CUDA card and the CUDA toolkit; without a card it exits
non-zero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 tensor-core rate
SM_HZ = 1.98e9                  # H100 SXM boost clock: sizes spin kernels

# Table-1 golden constants (seed 3, 20,000 ticks, window 64), the same
# values the reference's engine tests hold.
GOLDEN_JOB = {"ecmp_base": 10757, "ecmp_sym": 7900}
GOLDEN_FLOWS = {
    "ecmp_base": [
        9296, 7344, 7659, 8375, 8795, 9180, 9359, 9439, 10450, 10648, 10728,
        10601, 10268, 10348, 9887, 10228, 10658, 10757, 10754, 10205, 10011,
        10053, 10007, 10383, 9050, 9050, 9009, 8801, 8734, 9119, 9081, 9107],
    "ecmp_sym": [
        7853, 7891, 7769, 7877, 7837, 7864, 7698, 7900, 7845, 7894, 7802,
        7889, 7807, 7843, 7699, 7893, 7824, 7892, 7825, 7878, 7748, 7860,
        7698, 7861, 7853, 7877, 7764, 7877, 7747, 7835, 7692, 7891],
}
# Kernels and plain versions add every float sum in the same order and
# without fused multiply-adds, so they should agree to the bit; the
# tolerance admits a few ulps (float32 ulp ~ 6e-8 relative) and no more.
RTOL = 1e-6
# The window kernel's per-job throughput sample is a block reduction, in
# another order than torch's sum(dim=2).
RTOL_TPUT = 1e-5
# the tick kernel's float outputs and the window kernel's float state
FLOAT_OUTPUTS = ("eff", "offered", "q", "p_red", "s_psnwin", "s_alpha",
                 "s_cnt", "s_cntop", "sent", "rate", "target", "alpha_cc",
                 "lam")
INT_SERIES = ("finish_ticks", "job_finish_ticks", "ts_min_wire",
              "ts_max_wire", "ts_done_min", "ts_alpha_max")
PHASES = ("build", "math", "kernel", "window", "tiled", "large", "switch",
          "flash", "flash_bwd", "prefill", "serve", "train", "ssd", "mamba",
          "moe", "jamba", "mla", "vlm", "whisper", "multipod", "lanes",
          "ring", "dp", "ep", "gpipe", "tp", "launch", "goldens", "grid512",
          "control", "timing", "profile")
# (F, FW, H, L+1, J, DJ) of the multipod grids the tick and window kernels
# run at 128 hosts (ids in shared memory) and 512 hosts (ids in global
# memory); kernel and large check them against the builders'
NETSIM_DIMS = {"multipod128": (128, 8192, 6, 449, 1, 17),
               "multipod512": (512, 32768, 6, 1793, 1, 65)}
# instance tile of the tiled tick at each shape (a multiple of the window)
BLK = {"table1": 256, "multipod128": 1024, "multipod512": 2048}
# the shape of each kernel's main path, whose timing goes in the report
MAIN_SHAPE = {"netsim_tick": "multipod128", "netsim_window": "multipod128",
              "netsim_tiled": "multipod512",
              "switch_pipeline": "P=1000000", "flash_fwd": "S=32768",
              "flash_dq": "B=2 S=4096", "flash_dkv": "B=2 S=4096",
              "ssd": "B=8 S=32768"}
# the reference's FLASH_CASES (tests/test_kernels.py:19-26):
# (BH, query rows per KV row, S, D, window)
FLASH_CASES = ((4, 2, 256, 64, 0), (2, 1, 512, 128, 0), (4, 4, 256, 64, 128),
               (2, 2, 384, 64, 0), (8, 1, 256, 64, 64))
# the tolerances of the reference's flash tests: (o, lse) by dtype
FLASH_TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-5)}
# Held on top of those, against plain versions computed in float32: each
# row's max |error| over the head dim against that row's max |o| (the
# absolute 2e-2 is above |o| itself where thousands of keys average out,
# while a kernel's bf16 output is within 2^-8 of each value), and lse to
# 1e-4 (float32 sums of the same bf16 products).
ROW_TOL = 2e-2
LSE_ABS = 1e-4
# the model tolerance of tests/test_models.py:108-110 (bf16 weights,
# different contraction orders)
MODEL_ATOL, MODEL_RTOL = 0.15, 0.1
# The backward against its plain version: rows as for the forward, except
# that a row whose exact gradient is 0 (query 0 sees only key 0, so its ds
# is 0) has nothing to be relative to: each row's denominator is floored at
# ROW_FLOOR of the tensor's largest |value|.  float32 also at the
# reference's gradient tolerance (tests/test_kernels.py:49-70).
ROW_FLOOR = 1e-3
REF_GRAD_TOL = 5e-4
# one step's gradients at full width, flash kernels against the plain path
# (bf16 activations on both, attention rounded differently): relative L2
# distance per parameter leaf (2.5e-3 at most when measured), and the loss
GRAD_REL_L2 = 1e-2
GRAD_LOSS_RTOL = 1e-3
PREFILL_S = 32768               # prefill_32k's sequence, cut to batch 1
TRAIN_B = 2                     # train_4k's batch of 256, cut to 2
TRAIN_S = 4096                  # train_4k's sequence
TRAIN_STEPS = 6                 # timed steps after one warm-up step
BWD_WINDOWS = (8192, 1024)      # danube's window (no bite at S 4,096) and
                                # one that bites
FLASH_S = 4096                  # danube-headed checks of the plain version
WARM = 300                      # eager ticks before the kernel checks
# the reference's SSD_CASES (tests/test_kernels.py:75-80): (B, S, H, P, N,
# chunk, x drawn in bf16), each run with float32 and with bf16 B/C
SSD_CASES = ((2, 256, 3, 32, 16, 64, False), (1, 128, 2, 64, 32, 32, False),
             (2, 200, 2, 32, 16, 64, False), (2, 256, 4, 64, 16, 128, True))
# the reference's SSD tolerance (tests/test_kernels.py:101-104), atol and
# rtol, on y and the final state
SSD_TOL = 5e-4
# the main path's scan: mamba2-130m's heads, state, head dim and chunk at
# prefill_32k's sequence, batch cut to MAMBA_B: (B, S, H, P, N, chunk)
MAMBA_B = 8                     # prefill_32k's batch of 32, cut to 8
SSD_MAIN = (MAMBA_B, 32768, 24, 64, 128, 128)
# jamba's scan at prefill_32k cut to batch 1: 128 heads (d_inner 8,192 /
# head dim 64), state 16
JAMBA_SSD = (1, 32768, 128, 64, 16, 128)
# planted faults of the SSD check, at B = H (so that row bh % H exists)
SSD_FAULT_SHAPE = (4, 4096, 4, 64, 128, 128)
SSD_FAULTS = ("state not carried", "diagonal of L dropped",
              "B/C row bh % H", "off-chunk term without exp(cum)",
              "state decayed by exp(cum[0])")
# the reference's bf16 tolerance for the SSM's decode against prefill
# (tests/test_models.py:127-130: the chunked scan against the per-token
# recurrence).  At full width bf16 roundings amplify through 24 layers (the
# gated RMSNorm rescales near-zero head vectors): on an H100, decode vs
# prefill exceeds it on 10,328 of 12.9 M logits and the kernel vs plain
# prefill on 45 of 402,432, while every layer's scan passes the kernel
# check.  So both comparisons are held in float32 to the CPU tests' float32
# model tolerance (decode vs prefill: 1.1e-3 on logits up to 777 on an
# H100), and in bf16 as follows, the counts beyond the tolerances above
# reported.  At this init each row's largest logit is the input token's own
# (about 776, where a bf16 ulp is 4), so that one logit is held alone,
# relative to itself, to ECHO_RTOL (four ulps at the foot of its binade);
# the rest of each row as a relative L2 distance, to BF16_REL_L2; every
# argmax must agree (on an H100: 0.0055 kernel vs plain, 0.0075 decode vs
# prefill).  The scan adds little to the logits at this init: a control
# prefill whose scan in FAULT_LAYER drops the diagonal of L reads 0.0067
# there, so it is held to fail the float32 check, its bf16 reading
# reported.
DECODE_ATOL, DECODE_RTOL = 0.3, 0.15
F32_ATOL, F32_RTOL = 1e-3, 1e-4
ECHO_RTOL = 2.0 ** -6
BF16_REL_L2 = 2e-2
FAULT_LAYER = 12
# the served slot replayed alone (slot 0 takes requests 0 and 8)
REPLAY_SLOT = 0
# granite-moe-1b-a400m at full width: prefill_32k's batch of 32 cut to 8
# (at 32 the bf16 logits alone take 103 GB): 32 dispatch chunks of 8,192
# tokens a layer
MOE_B = 8
GRANITE_PARAMS = 1_334_628_352
# jamba-v0.1-52b at full width cut to one period, 8 of its 32 layers (the
# 51.2 B parameters take 95 GiB in bf16); prefill_32k cut to batch 1
JAMBA_LAYERS = 8
JAMBA_PERIOD_PARAMS = 12_999_163_392
# the prompt each family decodes token by token against its prefill
DECODE_T = 256
# The MLA, M-RoPE and encoder-decoder families at full width (bf16 weights
# drawn on the card from seed 0): the reference's param_count of each
# minicpm3-4b cut to 31 of its 62 layers (the whole script's time limit);
# the other families at full depth
LEFT3_LAYERS = {"minicpm3_4b": 31}
LEFT3_PARAMS = {"minicpm3_4b": 2_130_952_704,
                "qwen2_vl_2b": 1_543_656_960,
                "whisper_large_v3": 1_537_303_040}
# their flash forward shapes, held against the plain version in *flash*
# (S 4,096 for the decoders; whisper's teacher-forced prefill) and timed
# in *timing* at the prefills' (S 32,768; whisper's as checked):
# (name, B, query heads, KV heads, S, D)
FAMILY_FLASH = {"mla": ("minicpm3", 1, 40, 40, FLASH_S, 96),
                "vlm": ("qwen2-vl", 1, 12, 2, FLASH_S, 128),
                "whisper": ("whisper", 16, 20, 20, 384, 64)}
# the whole-model check, kernel vs plain path, of minicpm3 and qwen2-vl:
# last-token logits of a 1 x PLAIN_S prefill (at 32,768 the plain path's
# chunked float32 attention takes ~1.05 s a minicpm3 layer, 62 of them,
# on an NVIDIA H100 80GB HBM3 at 700 W)
PLAIN_S = 4096
# minicpm3's and qwen2-vl's serving cell: 8 requests of 16-48 prompt tokens,
# 16 new each (a decode call walks 31 layers for minicpm3)
LEFT3_REQUESTS, LEFT3_NEW = 8, 16
# the reference's MLA decode-vs-prefill tolerance (tests/test_models.py:
# 134-150)
MLA_DECODE_ATOL, MLA_DECODE_RTOL = 0.2, 0.1
# whisper-large-v3: prefill_32k's batch of 32 cut to 16 (its teacher-forced
# decoder at 384 tokens, the largest multiple of flash's 128 rows within
# the 448 learned positions), 1,500 encoder frames (30 s of audio, the stub
# frontend's output); greedy decode of WHISPER_STEPS tokens
WHISPER_B, WHISPER_S, WHISPER_STEPS = 16, 384, 64
# jamba's decode against its prefill, in bf16: the largest relative L2
# distance of a position's logits.  The reference's own jamba SMOKE model
# parts by 3.9 % there (bf16 SSM state and conv window steps against the
# chunked scan; the port's: 4.2 %, on the CPU), against 0.8 % for mamba2's
# SMOKE and 4e-4 for jamba in float32 (its bf16 KV cache): held at 2.5x.
HYBRID_DECODE_REL_L2 = 0.1
# the lane split: 128 hosts x 8 seeds over the card named 2 and 3 times;
# at tick_window=1 the shares' host threads contend for the interpreter
# (2,000 ticks took 47 s and 127 s split, 15 s on one device, on an H100
# host), so those runs are cut to LANES_TW1_TICKS ticks
LANE_SPLITS = (2, 3)
LANES_TW1_TICKS = 500
# the ring phase: the card named 4 and 8 times; (pods, ranks a pod) of the
# hierarchical cases; the reference test's sweep (tests/test_collectives.py:
# 29-86) and its tolerance against the plain sum; the timed all-reduce's
# float32 elements a rank (256 MiB)
RING_RANKS = (4, 8)
RING_PODS = {4: (2, 2), 8: (2, 4)}
RING_SHAPES = ((8, 16), (16, 7, 3), (64,))
RING_VARIANTS = {"plain": {}, "channels=2": {"channels": 2},
                 "bidirectional": {"bidirectional": True}}
RING_TOL = (2e-2, 1e-2)
RING_BIG = 64 << 20
# the dp phase: danube at full width cut to 2 of its 24 layers (4 replicas
# with float32 master, m and v fit the card: ~6.9 GB each), train_4k's
# sequence at a global batch of 4 (one row a rank), 3 steps per sync mode;
# step 0's synced gradients against one device's on the whole batch through
# a float32 copy of the model (the ranks' bf16 gradients, averaged in
# float32 on the ring, read 1.8e-2 on the tied embedding on an H100; the
# whole batch's own bf16 gradient there reads 7.8e-2 from float32, so it is
# no yardstick) and against the mean of one device's one-row bf16
# gradients (equal but for the synced mean's bf16 rounding, 2^-8)
DP_LAYERS = 2
DP_PARAMS = 432_556_800
DP_B, DP_STEPS = 4, 3
DP_GRAD_REL_L2 = 2e-2
DP_ROWS_REL_L2 = 2.0 ** -8
DP_LOSS_ABS = 1e-2
# the ep phase: granite's layer-0 MoE on 2 x 4,096 tokens over (data 2,
# model 4); the gpipe phase: 4 danube blocks as stages, 4 microbatches
EP_B, EP_S = 2, 4096
GPIPE_STAGES, GPIPE_MB = 4, 4
# the launch phase: the dry-run's records of these architectures' four cells
# on both production meshes; each card run's peak memory against the
# dry-run's predicted argument + output - alias + temp, within LAUNCH_BAND
# (relative); the faults planted in the decode cell's prediction
LAUNCH_ARCHS = ("h2o_danube_3_4b", "mamba2_130m")
# danube's prefill_32k held to the card on one rank of (data 32, model 1):
# a rank's share of the batch of 32 is 1 x 32,768 (its plain float32
# attention under the flop counter took 45 s at 2 x 32,768 on (16, 1): the
# whole script's time limit; at 8 of 24 layers the flash route's bf16
# logits part from the plain route's by 1.0, beyond the model tolerance)
LAUNCH_PREFILL_MESH = (32, 1)
# the partitioned record held to the card: danube train_4k on one rank of
# (data 16, model 16) at depth 2, its peak within TP_LAUNCH_BAND
TP_LAUNCH = ("h2o_danube_3_4b", "train_4k", (16, 16), 2)
TP_LAUNCH_BAND = 0.05
# the tp phase: danube at full width cut to DP_LAYERS layers on (data 2,
# model 4), float32, a global batch of TP_B x 4,096, one step of the
# tensor-parallel make_train_step (xla, fsdp, ring) against one device's
# on the same padded tree.  On CPU ranks at smoke width the step reads
# (tests/test_torch_tp.py): losses 1.2e-7 relative, gradient norms
# equal, gradients per leaf within 1e-4 rtol; the card's float32 matrix
# products split differently at a rank's width, so gradients are held at
# a relative L2 distance of TP_GRAD_REL_L2 a leaf, losses and norms at
# TP_LOSS_RTOL, and each leaf's update (AdamW's first step at the warm-up
# peak moves an entry by about lr times its gradient's sign, so an entry
# whose gradient lies within rounding of 0 may move the other way) at a
# relative L2 distance of TP_UPDATE_REL_L2
TP_MESH, TP_B = (2, 4), 4
TP_GRAD_REL_L2 = 1e-4
TP_LOSS_RTOL = 1e-5
TP_UPDATE_REL_L2 = 1e-2
# the tp prefill: danube's 24 layers, 1 x 32,768 tokens on (data 1, model 4)
TP_PREFILL_MESH = (1, 4)
# the tp phase's MoE family: granite at full width, its step cut to
# DP_LAYERS layers in float32 on TP_MESH at a global batch of TP_B x 4,096
# and capacity factor TP_MOE_CF, where no assignment drops on either side
# (one device: C_loc = T k cf^2 / E >= T, the most an expert can get; a
# model-4 rank: C_loc = 4 T, each of the 4 ranks sending an expert at most
# its T tokens; the send buffers' 2 T k / 4 rows a destination hold twice
# the mean, and their drops are counted); one device's aux taken as the
# mesh program defines it (the mean of the ranks' auxes, mesh_aux).  Its
# prefill of 1 x 32,768 tokens on TP_PREFILL_MESH, cut to
# TP_MOE_PREFILL_LAYERS of 24 layers for the script's time limit, and one
# full-width MoE layer inside the ranks run at granite's own capacity 1.25.
TP_MOE = "granite_moe_1b_a400m"
TP_MOE_CF = 2.0
TP_MOE_PREFILL_LAYERS = 12
# the partitioned MoE record held to the card
TP_LAUNCH_MOE = (TP_MOE, "train_4k", (16, 16), 2)
# the tp phase's SSM and hybrid families.  mamba2 at full width: its step
# cut to DP_LAYERS layers in float32 on TP_MESH at a global batch of TP_B x
# 4,096 (xla, ring: the plain scan, the SSD kernel being forward only), as
# granite's; its 24 layers prefilling 1 x 32,768 on TP_PREFILL_MESH
# through the SSD kernel at a rank's 6 heads, in float32 against one
# device at F32_ATOL / F32_RTOL (bf16 roundings build up through 24
# layers: see the mamba phase) and in bf16 by rows (ROW_TOL of each row's
# largest |logit|, rows TP_ROWS) and argmax.  jamba's first period
# (JAMBA_LAYERS) prefilling 1 x 32,768 in bf16 on TP_PREFILL_MESH with the
# flash and SSD kernels, held to one device as mamba2's bf16 rows, at its
# own capacity factor (the drops of each MoE layer reported on both sides);
# its layer 0 (an SSM layer and an MLP) inside the ranks in float32 on
# 1 x 32,768 N(0,1) inputs against one device within TP_LAYER_REL_L2
TP_SSM = "mamba2_130m"
TP_HYBRID = "jamba_v0_1_52b"
TP_ROWS = slice(255, None, 256)
TP_LAYER_REL_L2 = 1e-4
# the partitioned hybrid record held to the card: jamba's first period
TP_LAUNCH_HYBRID = (TP_HYBRID, "train_4k", (16, 16), JAMBA_LAYERS)
# the tp phase's MLA family: minicpm3 at full width, its step cut to
# DP_LAYERS layers in float32 on TP_MESH at a global batch of TP_B x 4,096
# (xla, ring; q_lora over model, 192 of 768 a rank; 10 of 40 heads a rank)
# as granite's; LEFT3_LAYERS of it prefilling 1 x 32,768 in bf16 with the
# flash forward on TP_PREFILL_MESH, held to one device by rows (ROW_TOL of
# each row's largest |logit|, rows TP_ROWS) and argmax as mamba2's bf16
# prefill; its partitioned record held to the card as the others
TP_MLA = "minicpm3_4b"
TP_LAUNCH_MLA = (TP_MLA, "train_4k", (16, 16), 2)
# the launch phase's meta runs (launch_task), all started with the run in
# LAUNCH_WORKERS worker processes at the lowest priority, so that the phase
# waits for none and the host-bound phases meanwhile keep the other cores:
# first the predictions that the card's runs are held to (jamba's, the
# longest, first), then the records (mamba2's prefill and train, the
# longest, first)
LAUNCH_PREDS = {
    "tp_hybrid": ("predict",) + TP_LAUNCH_HYBRID,
    "tp_mla": ("predict",) + TP_LAUNCH_MLA,
    "prefill": ("predict", "h2o_danube_3_4b", "prefill_32k",
                LAUNCH_PREFILL_MESH, None),
    "train": ("predict", "h2o_danube_3_4b", "train_4k", (16, 1), 2),
    "decode": ("predict", "mamba2_130m", "decode_32k", (1, 1), None),
    "tp": ("predict",) + TP_LAUNCH,
    "tp_moe": ("predict",) + TP_LAUNCH_MOE}
LONG_RECORDS = (("mamba2_130m", "prefill_32k"), ("mamba2_130m", "train_4k"))
LAUNCH_RECORDS = tuple(
    ("record", a, s, mp)
    for a, s in LONG_RECORDS + tuple(
        (a, s) for a in LAUNCH_ARCHS
        for s in ("prefill_32k", "train_4k", "decode_32k", "long_500k")
        if (a, s) not in LONG_RECORDS)
    for mp in (False, True))
LAUNCH_WORKERS = 3
LAUNCH_BAND = 0.15
LAUNCH_FAULTS = ("donation ignored", "cache dropped")


def host_ms() -> float:
    """Milliseconds that a fixed loop of 200,000 Python additions takes: a
    reading of the host's speed, and of contention for its cores, beside
    each phase's time."""
    t0, n = time.perf_counter(), 0
    for i in range(200_000):
        n += i
    return 1e3 * (time.perf_counter() - t0)


def memory_band(measured: int, predicted: int,
                band: float = LAUNCH_BAND) -> tuple[bool, float]:
    """Whether a measured peak lies within ``band`` (relative) of the
    dry-run's predicted bytes, and the relative distance."""
    rel = abs(measured - predicted) / predicted
    return rel <= band, rel


def planted_memory(mem: dict, fault: str, cache_bytes: int) -> int:
    """The predicted total of a dry-run with a planted fault: the donated
    cache's aliasing ignored, or its ``cache_bytes`` left out of the
    arguments and outputs."""
    m = dict(mem)
    if fault == "donation ignored":
        m["alias"] = 0
    elif fault == "cache dropped":
        for k in ("argument", "output", "alias"):
            m[k] -= cache_bytes
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return m["argument"] + m["output"] - m["alias"] + m["temp"]


def launch_task(task: tuple) -> dict:
    """One dry-run over meta devices, in a worker process of the launch
    phase: ``("record", arch, shape, multi_pod)`` is the production
    record; ``("predict", arch, shape, mesh_shape, depth)`` the meta
    measurement of the cell on a (data, model) mesh of that shape."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    if task[0] == "record":
        return dryrun.run_cell(*task[1:])
    _, arch, shape, mesh_shape, depth = task
    mesh = make_mesh(mesh_shape, ("data", "model"),
                     ["meta"] * (mesh_shape[0] * mesh_shape[1]))
    return dryrun.measure(build_cell(arch, shape, mesh,
                                     depth_override=depth))


# the golden runs that start_goldens runs in worker processes: (tick_window,
# blk) of the tick kernel's and the tiled kernel's tick_window=1 runs
GOLDEN_EARLY = ((1, None), (1, BLK["table1"]))


def golden_task(tw: int, blk) -> dict:
    """One Table-1 golden run (seed 3, ecmp, sym off and on as two lanes)
    through backend "cuda" at ``tick_window`` ``tw`` and ``blk`` on the
    card, its launch counts set to 0 before it: its seconds, (tick,
    window, tiled) launches, and each lane's job and flow finish ticks.
    The goldens phase takes its tick_window=1 runs from worker processes
    (``Smoke.start_goldens``)."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.netsim as T
    from repro_torch.kernels.netsim_tick import kernel as K
    from repro_torch.kernels.netsim_tick import tiled as Tl
    from repro_torch.kernels.netsim_tick import window as Wn
    topo, wl, cfg = table1(T)
    knobs = T.stack_knobs([cfg.knobs(), cfg._replace(sym_on=True).knobs()])
    K.netsim_tick.launches = Wn.netsim_window.launches = 0
    Tl.netsim_tiled.launches = 0
    t0 = time.time()
    res = T.simulate_grid(
        topo, wl, cfg._replace(
            backend="cuda", tick_window=tw, blk=blk,
            segsum="onehot" if blk else "scatter").structure(),
        knobs, seeds=[3], routing="ecmp", device=torch.device("cuda"))
    torch.cuda.synchronize()
    return {"secs": time.time() - t0,
            "launches": (K.netsim_tick.launches, Wn.netsim_window.launches,
                         Tl.netsim_tiled.launches),
            "job": [int(res.job_finish_ticks[k, 0, 0]) for k in range(2)],
            "flows": [res.finish_ticks[k, 0].cpu().tolist()
                      for k in range(2)]}


def _tree_items(tree, prefix=()):
    """(path, tensor) of every tensor in nested dicts, lists, tuples and
    NamedTuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def table1(T):
    topo = T.make_leaf_spine(32, 4, 4)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32)), ring_size=8, chunk_bytes=1e6,
                   passes=2, barrier=False)
    return topo, b.build(), T.SimParams(n_ticks=20_000, window=64)


def multipod(T, n_pods: int, n_ticks: int):
    """benchmarks/grid512.py's full configuration at ``32 * n_pods`` hosts:
    pods of 4 ToRs x 8 hosts with 4 spines, 8 cores at 1:2
    oversubscription, rings of 32, 8 MB chunks, coarse 20 us ticks; cut to
    ``n_ticks`` ticks."""
    topo = T.make_fat_tree(n_pods, 4, 4, 8, 8, core_oversubscription=2.0)
    b = T.WorkloadBuilder()
    b.add_ring_job(hosts=list(range(32 * n_pods)), ring_size=32,
                   chunk_bytes=8e6, passes=1, barrier=False)
    cfg = T.SimParams(n_ticks=n_ticks, window=64, dt=20e-6, sym_win_ticks=5,
                      cc_epoch_ticks=2)
    return topo, b.build(), cfg


def multipod128(T):
    """The 128-host grid (4 pods, 4 spines a pod, 8 cores at 1:2), cut to
    2,000 ticks."""
    return multipod(T, 4, 2000)


SHAPES = {"table1": table1, "multipod128": multipod128,
          "multipod256": lambda T: multipod(T, 8, 1000),
          "multipod512": lambda T: multipod(T, 16, 1000)}


def lane_knobs(T, cfg):
    """The four knob points (sym_on, pq_on) in {0,1}^2."""
    return T.stack_knobs([
        cfg._replace(sym_on=bool(i % 2), pq_on=bool(i // 2)).knobs()
        for i in range(4)])


def row_err(o, ref) -> float:
    """The largest row error of ``o`` against ``ref`` ([..., D]): each
    row's max |difference| over the last dim over that row's max |ref|."""
    r = ref.float()
    d = (o.float() - r).abs().amax(-1)
    return (d / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def logit_gap(got, want) -> str:
    """Where two paths' float logits part, against the model tolerance's
    element bound MODEL_ATOL + MODEL_RTOL * |want|: the largest difference
    and |want| there, the element nearest its bound (or furthest past it)
    with its |want|, how many elements pass their bound, and the row error
    (:func:`row_err`)."""
    d, w = (got - want).abs().flatten(), want.abs().flatten()
    bound = MODEL_ATOL + MODEL_RTOL * w
    i, j = int(d.argmax()), int((d / bound).argmax())
    return (f"max abs err {d[i].item():.4g} at |logit| {w[i].item():.4g}; "
            f"nearest its bound {d[j].item():.4g} of {bound[j].item():.4g} "
            f"at |logit| {w[j].item():.4g}; {int((d > bound).sum())} of "
            f"{d.numel()} past it; row error {row_err(got, want):.3g}")


def chunked_lse(torch, q, k, window: int, scale: float, chunk: int = 512):
    """lse [B, S, Hq] float32 of causal attention (with a sliding window
    when ``window``) of q [B, S, Hq, D] over k [B, S, Hkv, D], ``chunk``
    query rows at a time: the plain check of the kernel's lse at lengths
    whose [S, S] scores do not fit."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    kf = k.float()
    pos = torch.arange(S, device=q.device)
    out = torch.empty((B, S, Hq), dtype=torch.float32, device=q.device)
    for i in range(0, S, chunk):
        qg = q[:, i:i + chunk].float().reshape(B, -1, Hkv, Hq // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kf) * scale
        qp, kp = pos[i:i + chunk, None], pos[None]
        ok = kp <= qp
        if window:
            ok &= kp > qp - window
        s.masked_fill_(~ok[None, :, None, None], -1e30)
        out[:, i:i + chunk] = torch.logsumexp(s, -1).reshape(B, -1, Hq)
    return out


def faulty_ssd(torch, x, a, Bm, Cm, chunk: int, n_heads: int, fault: str):
    """A copy of the plain chunk walk (``ssd_chunked_ref``) with one
    planted fault of SSD_FAULTS: outputs a broken kernel would give."""
    BH, S, P = x.shape
    N, Q = Bm.shape[-1], chunk
    rows = torch.arange(BH, device=x.device)
    rows = rows % n_heads if fault == "B/C row bh % H" else rows // n_heads
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril(
        -1 if fault == "diagonal of L dropped" else 0)
    zero = torch.zeros((), device=x.device)
    state = torch.zeros((BH, N, P), device=x.device)
    y = torch.empty((BH, S, P), device=x.device)
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xk = x[:, sl].float()
        cum = a[:, sl].float().cumsum(-1)
        Bk, Ck = Bm[rows, sl].float(), Cm[rows, sl].float()
        if fault == "state not carried":
            state = torch.zeros_like(state)
        L = torch.where(tri, torch.exp(cum[:, :, None] - cum[:, None, :]),
                        zero)
        off = Ck if fault == "off-chunk term without exp(cum)" else \
            Ck * torch.exp(cum)[..., None]
        y[:, sl] = ((Ck @ Bk.transpose(1, 2)) * L) @ xk + off @ state
        decay = cum[:, 0] if fault == "state decayed by exp(cum[0])" \
            else cum[:, -1]
        state = state * torch.exp(decay)[:, None, None] + (
            Bk * torch.exp(cum[:, -1:] - cum)[..., None]).transpose(1, 2) @ xk
    return y, state


def tensor_bytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def timed(fn, n: int, torch) -> tuple[float, float]:
    """``(device ms, wall ms)`` per call of ``fn`` over ``n`` calls, after
    a warm-up, from CUDA events.  Wall: the calls made one after another,
    host time between them included.  Device: the same calls queued behind
    a spin kernel that outlasts queueing them, so that the card runs them
    back to back and the events span only their device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = a.elapsed_time(b) / n
    torch.cuda._sleep(int((2 * enqueue_s + 0.005) * SM_HZ))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, wall


def profile_ticks(run, torch) -> tuple[float, dict]:
    """Profile ``run()``: returns ``(wall us, {kernel name: (count,
    device us)})``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    return wall_us, by_name


def lane_split_check(torch, got, want) -> tuple[bool, str]:
    """A grid run split over devices (``got``) against its one-device run
    (``want``), two SimResults: (ok, message).  Every integer series bit
    for bit, the float series allclose at RTOL_TPUT; the message also
    counts the float elements whose bits differ."""
    bad = [f for f in INT_SERIES if not torch.equal(getattr(got, f),
                                                    getattr(want, f))]
    close, bits = True, []
    for f in ("ts_throughput", "ts_qmax"):
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape:
            close = False
            bits.append(f"{f} shapes {tuple(a.shape)} and {tuple(b.shape)}")
            continue
        close &= bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=RTOL_TPUT)
        n = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        bits.append(f"{f} {n} of {b.numel()}")
    return not bad and close, (
        "integer series " + (f"differ in {', '.join(bad)}" if bad else
                             "bit-equal") + f"; float series within rtol "
        f"{RTOL_TPUT}: {close}; elements whose bits differ: "
        + ", ".join(bits))


@contextlib.contextmanager
def renumbered_shares(sim):
    """Within: a planted fault of the lane split (``sim`` is
    repro_torch.core.netsim.simulator): every share renumbers its lanes
    from 0, as if it were a grid of its own, so a share that starts past
    lane 0 runs the first lanes' seeds and knob points."""
    run = sim._run_lanes

    def renumbered(topo, wl, struct, knobs, seeds, routing, lanes, dev, bg):
        if lanes is not None:
            lanes = lanes - lanes[0]
        return run(topo, wl, struct, knobs, seeds, routing, lanes, dev, bg)

    sim._run_lanes = renumbered
    try:
        yield
    finally:
        sim._run_lanes = run


@contextlib.contextmanager
def moe_drop_counter(moe):
    """Within: the assignments each MoE dispatch chunk drops at capacity
    (``moe`` is repro_torch.models.moe), appended in call order as 0-d
    tensors on the chunk's device (no host sync)."""
    seen, slots = [], moe._slots

    def counting(flat_e, cfg, T):
        ekeep, slot = slots(flat_e, cfg, T)
        seen.append(flat_e.shape[0] - ekeep.sum())
        return ekeep, slot

    moe._slots = counting
    try:
        yield seen
    finally:
        moe._slots = slots


def per_layer(torch, counts, n_layers: int) -> list[int]:
    """Per-chunk counts of one forward (call order) summed per layer."""
    if not counts:
        return [0] * n_layers
    return torch.stack(counts).view(n_layers, -1).sum(1).tolist()


# ------------------------------------------------ ring, dp, ep and gpipe

def ring_cases(torch, devices, n: int, big: bool = False) -> dict:
    """The ring phase's collectives over ``n`` ranks on ``devices`` (a list
    of n devices, a name repeated): ``{case: (output on the CPU, ppermute
    counts, counts wanted, plain result or None, (rtol, atol) or None)}``.
    Inputs come from a CPU generator seeded with ``n``: N(0,1) float32 and
    bf16 at the reference test's shapes, its (pod, data) hierarchies, its
    gradient trees (``bucket_bytes=64``), and with ``big`` a RING_BIG-element
    float32 block a rank."""
    from repro_torch.collectives import (hierarchical_all_reduce,
                                         ring_all_gather, ring_all_reduce,
                                         ring_all_reduce_nd,
                                         ring_reduce_scatter,
                                         sync_grads_local)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import decode_int8, encode_int8
    from repro_torch.parallel.spmd import P, ppermute, shard_map
    flat = make_mesh((n,), ("data",), devices)
    pods, inner = RING_PODS[n]
    two = make_mesh((pods, inner), ("pod", "data"), devices)
    g = torch.Generator().manual_seed(n)
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def run(name, fn, x, mesh, spec, counts, plain=None, tol=None,
            out_spec=P()):
        ppermute.counts.clear()
        y = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=out_spec)(x)
        if isinstance(y, dict):       # a gradient tree, flattened
            y = torch.cat([y["a"].reshape(-1), y["b"]["c"].reshape(-1)])
        out[name] = (y.cpu(), dict(ppermute.counts), counts, plain, tol)

    ring = 2 * (n - 1)
    for shape in RING_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape).to(dtype)
            plain = x.float().reshape((n, shape[0] // n) + shape[1:]).sum(0)
            dt = str(dtype).split(".")[1]
            for v, kw in RING_VARIANTS.items():
                rings = kw.get("channels", 1) * (
                    2 if kw.get("bidirectional") else 1)
                run(f"ring_all_reduce {shape} {dt} {v}",
                    lambda a, kw=kw: ring_all_reduce(a.float(), "data", **kw),
                    x, flat, P("data"), {"data": ring * rings}, plain,
                    RING_TOL)
            run(f"ring_all_reduce_nd {shape} {dt}",
                lambda a: ring_all_reduce_nd(a.float(), "data"), x, flat,
                P("data"), {"data": ring}, plain, RING_TOL)
    x = randn(n, 32)
    run("ring_reduce_scatter + ring_all_gather",
        lambda a: ring_all_gather(ring_reduce_scatter(a, "data"), "data"),
        x, flat, P(), {"data": ring}, n * x, (1e-5, 1e-5))
    hier = {"data": 2 * (inner - 1), "pod": 2 * (pods - 1)}
    x = randn(n, 40)
    run(f"hierarchical_all_reduce ({pods}, {inner})",
        lambda a: hierarchical_all_reduce(a, "data", "pod"), x, two,
        P(("pod", "data")), hier, x.sum(0, keepdim=True), (1e-4, 1e-4))
    x = randn(n, 4096)          # int8 shards of whole BLOCKs
    run(f"hierarchical_all_reduce ({pods}, {inner}) int8",
        lambda a: hierarchical_all_reduce(
            a, "data", "pod", compress=(encode_int8, decode_int8)), x, two,
        P(("pod", "data")), hier, x.sum(0, keepdim=True))
    grads = {"a": randn(n, 6, 5), "b": {"c": randn(n, 33)}}
    spec = {"a": P(("pod", "data")), "b": {"c": P(("pod", "data"))}}
    mean = torch.cat([grads["a"].mean(0, keepdim=True).expand(
        n, 6, 5).reshape(-1), grads["b"]["c"].mean(0, keepdim=True).expand(
            n, 33).reshape(-1)])
    for mode, counts in (("ring", {"pod": 2 * 2 * (pods - 1),
                                   "data": 2 * 2 * (inner - 1)}),
                         ("hierarchical", {"data": 2 * 2 * (inner - 1),
                                           "pod": 2 * 2 * (pods - 1) * 4}),
                         ("psum", {})):
        run(f"sync_grads_local {mode}",
            lambda t, mode=mode: sync_grads_local(
                t, ("pod", "data"), mode=mode, bucket_bytes=64),
            grads, two, (spec,), counts, mean, (1e-5, 1e-5), out_spec=spec)
    if big:
        x = randn(n, RING_BIG)
        run(f"ring_all_reduce [{n}, {RING_BIG}] float32",
            lambda a: ring_all_reduce(a, "data"), x, flat, P("data"),
            {"data": ring}, x.sum(0, keepdim=True), RING_TOL)
    return out


def ring_case_ok(case) -> bool:
    """A ring case's output within its tolerance of its plain result."""
    import torch
    y, _, _, plain, tol = case
    return plain is None or tol is None or torch.allclose(
        y.float(), plain.float(), rtol=tol[0], atol=tol[1])


@contextlib.contextmanager
def planted_ring(ring, fault: str):
    """Within: a planted fault of the rings (``ring`` is
    repro_torch.collectives.ring), a patched copy of its function: "shifted
    by two" sends every step to the rank two ahead; "last step dropped"
    stops the reduce-scatter one step early."""
    saved = ring._perm, ring.ring_reduce_scatter
    if fault == "shifted by two":
        ring._perm = lambda n, shift=1: [(i, (i + 2 * shift) % n)
                                         for i in range(n)]
    elif fault == "last step dropped":
        def short(x, axis, reverse=False):
            n = ring.axis_size(axis)
            idx = ring.axis_index(axis)
            k = x.shape[0] // n
            chunks = x.reshape((n, k) + tuple(x.shape[1:]))
            sgn = -1 if reverse else 1
            acc = chunks[(idx - sgn) % n]
            for s in range(1, n - 1):
                acc = chunks[(idx - sgn * (s + 1)) % n] + ring.ppermute(
                    acc, axis, ring._perm(n, sgn))
            return acc
        ring.ring_reduce_scatter = short
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        ring._perm, ring.ring_reduce_scatter = saved


@contextlib.contextmanager
def flash_calls_by_stream(torch, ops):
    """Within: the flash forward and backward wrappers' calls through
    ``ops`` (repro_torch.kernels.flash_attention.ops, whose autograd
    function calls them), counted per (direction, CUDA stream) under a
    lock: a rank's forward, remat recompute and backward all run on its
    stream."""
    counts, lock = collections.Counter(), threading.Lock()
    fwd, bwd = ops.flash_fwd, ops.flash_bwd

    def counted(kind, fn):
        def call(*args, **kw):
            with lock:
                counts[kind, torch.cuda.current_stream().cuda_stream] += 1
            return fn(*args, **kw)
        return call

    ops.flash_fwd, ops.flash_bwd = counted("fwd", fwd), counted("bwd", bwd)
    try:
        yield counts
    finally:
        ops.flash_fwd, ops.flash_bwd = fwd, bwd


@contextlib.contextmanager
def ssd_calls_by_stream(torch, ssm_mod):
    """Within: the SSM mixer's calls of the SSD scan (``ssm_mod`` is
    repro_torch.models.ssm, whose ``ssm_block`` calls ``ssd``), counted
    per CUDA stream under a lock: a rank's calls run on its stream."""
    counts, lock, scan = collections.Counter(), threading.Lock(), ssm_mod.ssd

    def counted(*args, **kw):
        with lock:
            counts[torch.cuda.current_stream().cuda_stream] += 1
        return scan(*args, **kw)

    ssm_mod.ssd = counted
    try:
        yield counts
    finally:
        ssm_mod.ssd = scan


def on_mesh(model, mesh):
    """A model of ``model``'s configuration on ``mesh`` holding
    ``model``'s own parameter tensors (not copies): the tensor-parallel
    program of the same tree, where the mesh pads nothing more."""
    from repro_torch.models.model import make_model
    from repro_torch.models.params import slot
    m = make_model(model.cfg, model.par, model.use_flash,
                   model.use_ssd_kernel, "meta", mesh)
    for name, p in model.named_parameters():
        mod, key = slot(m, name)
        if mod._parameters[key].shape != p.shape:
            raise ValueError(f"{name}: {tuple(p.shape)} on one device, "
                             f"{tuple(mod._parameters[key].shape)} on "
                             f"{dict(mesh.shape)}")
        mod._parameters[key] = p
    return m


@contextlib.contextmanager
def as_float32(model):
    """Within: ``model`` in float32, its weights widened (a tensor-parallel
    model's ranks cut anew from them) and exactly restored after."""
    cfg = model.cfg
    saved = {n: p.data for n, p in model.named_parameters()}
    model.cfg = dataclasses.replace(cfg, dtype="float32")
    for p in model.parameters():
        p.data = p.data.float()
    try:
        yield model
    finally:
        model.cfg = cfg
        for n, p in model.named_parameters():
            p.data = saved[n]


def finite_rel(torch, a, b) -> float:
    """The relative L2 distance of ``a`` from ``b``; infinite when it is
    not finite (a NaN then tops any ``max`` and fails every ``<=``)."""
    r = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return r if math.isfinite(r) else math.inf


def rows_agree(torch, got, want) -> tuple[float, float]:
    """bf16 logits of two paths ([rows, vocab]): (the largest row error,
    :func:`row_err`; the share of rows whose argmax agrees)."""
    same = got.float().argmax(-1).eq(want.float().argmax(-1))
    return row_err(got, want), same.float().mean().item()


@contextlib.contextmanager
def ep_drop_counter(moe):
    """Within: the assignments each expert-parallel dispatch chunk drops,
    at the send buffer's capacity and at the experts' (``moe`` is
    repro_torch.models.moe), as 0-d device tensors."""
    seen, slots, lock = {"send": [], "expert": []}, moe.ep_slots, \
        threading.Lock()

    def counting(bucket, n_buckets, cap, valid=None):
        keep, slot = slots(bucket, n_buckets, cap, valid)
        n = bucket.numel() if valid is None else valid.sum()
        with lock:
            seen["send" if valid is None else "expert"].append(
                n - keep.sum())
        return keep, slot

    moe.ep_slots = counting
    try:
        yield seen
    finally:
        moe.ep_slots = slots


@contextlib.contextmanager
def route_log(torch, moe):
    """Within: each call of the router (``moe._route``) records its expert
    ids [T, k] sorted per token.  Yields ``.forward``: a forward call's ids
    and the smallest gap between a token's k-th and (k+1)-th probability
    (one device's; None on a rank), in call order, under the calling rank's
    (data, model) coordinates, or None outside a rank; and ``.recompute``:
    the ids of every remat recompute inside a backward (on the autograd
    engine's thread, outside any rank)."""
    from repro_torch.parallel import spmd
    log = types.SimpleNamespace(forward=collections.defaultdict(list),
                                recompute=[])
    real, lock = moe._route, threading.Lock()

    def logged(xt, router, cfg):
        out = real(xt, router, cfg)
        ids = out[1].detach().sort(-1).values
        if torch._C._current_graph_task_id() != -1:
            with lock:
                log.recompute.append(ids)
            return out
        key, gap = None, None
        if spmd.in_rank():
            key = tuple(spmd.axis_index(a) for a in ("data", "model"))
        else:
            k = cfg.moe.experts_per_token
            with torch.no_grad():
                top = torch.softmax(xt.float() @ router, dim=-1).topk(
                    k + 1, dim=-1).values
                gap = (top[:, k - 1] - top[:, k]).min()
        with lock:
            log.forward[key].append((ids, gap))
        return out

    moe._route = logged
    try:
        yield log
    finally:
        moe._route = real


def remat_flips(torch, log) -> int:
    """The top-k sets that a :func:`route_log`'s remat recomputes gave and
    its forward calls did not, counted as multisets over every call (a
    recompute cannot name its rank: it runs on the autograd engine's
    thread); 0 without recomputes."""
    if not log.recompute:
        return 0
    fwd = torch.cat([i for recs in log.forward.values() for i, _ in recs])
    again = torch.cat(log.recompute).to(fwd.device)
    base = int(torch.maximum(fwd.max(), again.max())) + 1
    weights = base ** torch.arange(fwd.shape[-1], device=fwd.device)

    def rows(ids):
        return collections.Counter((ids * weights).sum(-1).tolist())

    return sum((rows(again) - rows(fwd)).values())


def route_flips(torch, one: list, ranks: dict, layers: int, rows: int,
                S: int, dp: int, tp: int) -> tuple[list[int], list[float]]:
    """From :func:`route_log`'s records of one device's forward (``one``,
    ``rows`` x ``S`` tokens) and the (dp, tp) ranks' (``ranks``) over
    ``layers`` MoE layers: the tokens per layer whose top-k set differs
    from one device's (each rank's tokens: its rows of the batch, and its
    sequence shard under Megatron-SP), and one device's smallest k-th to
    (k+1)-th probability gap per layer."""
    k = one[0][0].shape[-1]
    ids = torch.cat([i for i, _ in one]).view(layers, dp, rows // dp, S, k)
    gaps = torch.stack([g for _, g in one]).view(layers, -1).amin(1)
    flips = [0] * layers
    for (d, m), recs in ranks.items():
        got = torch.cat([i for i, _ in recs]).view(layers, -1, k)
        want = ids[:, d]
        if got.shape[1] != want[0, :, :, 0].numel():      # Megatron-SP
            want = want.view(layers, rows // dp, tp, S // tp, k)[:, :, m]
        diff = (got != want.reshape(got.shape).to(got.device)).any(-1)
        flips = [a + int(b) for a, b in zip(flips, diff.sum(1))]
    return flips, gaps.tolist()


@contextlib.contextmanager
def mesh_aux(torch, lm, moe, dp: int, tp: int):
    """Within: a one-device model's MoE layers (``lm`` is
    repro_torch.models.lm, ``moe`` repro_torch.models.moe) return the aux
    loss of the reference's mesh program on a (dp, tp) mesh, the mean of
    each rank's aux on its own tokens (the batch split over dp, the
    sequence over tp under Megatron-SP, else a data group's every token on
    each of its tp ranks); their outputs are the one-device path's."""
    real, route = lm.moe_block, moe._route

    def grouped(p, x, cfg, rules=None, mesh=None):
        y, _ = real(p, x, cfg)
        d = x.shape[-1]
        sp = x.shape[1] % tp == 0 and x.shape[1] > 1
        auxs = [route(xs.reshape(-1, d), p["router"], cfg)[2]
                for xb in x.chunk(dp, 0)
                for xs in (xb.chunk(tp, 1) if sp else [xb] * tp)]
        return y, torch.stack(auxs).sum() / len(auxs)

    lm.moe_block = grouped
    try:
        yield
    finally:
        lm.moe_block = real


def tp_family_counts(layers: int, chunks: int, ce_chunks: int, leaves: int,
                     replicated: int, sync: str, mlps: int = 0,
                     mla: int = 0) -> dict:
    """The collectives by kind of one TPStep of a MoE (``chunks`` dispatch
    chunks a layer), SSM or MLA model (``chunks`` 0) without FSDP on (data
    2, model 4), one mixer and one FFN (or none) a layer
    (tests/test_torch_tp_moe.py, tests/test_torch_tp_ssm.py and
    tests/test_torch_tp_mla.py hold the CPU ranks' run to the same
    derivation): the sequence all-gathered before each layer's mixer
    (attention or SSM), before each of the ``mlps`` MLPs and after the
    last layer, the embedding's, each mixer's and each MLP's partial
    product reduce-scattered, each with its transpose; per MLA layer (of
    ``mla``) the q latent's sum of squares psummed and the partial q
    reduce-scattered over model, each with its transpose; per MoE layer and dispatch chunk the router
    gathered whole (its transpose a reduce-scatter) and again in the
    recompute, two token all_to_alls with their transposes and one of
    expert ids, and the aux's pmean over (data, model) with its
    transpose; the loss's pmean over data with its transpose; the loss's
    pmax and psum a cross-entropy chunk (the psum's transpose too); the
    ``replicated`` leaves (those not sharded over model) summed over it
    and the norm's psum; the ``leaves`` summed over data (xla), or
    ring-synced over its 2 ranks (two collective-permutes a leaf)."""
    L, c = layers, chunks
    out = {"all-gather": 2 * (L + mlps) + 2 + 2 * L * c + mla,
           "reduce-scatter": 2 * (L + mlps) + 2 + L * c + mla,
           "all-reduce": 3 * ce_chunks + replicated + 1 + 2 +
           (2 * L if c else 0) + 2 * mla}
    if c:
        out["all-to-all"] = 5 * L * c
    if sync == "xla":
        out["all-reduce"] += leaves
    else:
        out["collective-permute"] = 2 * leaves
    return out


def danube_block(cfg, p: dict, x, positions, use_flash: bool = True):
    """One dense danube layer from a plain dict of its parameters (the
    sequence of ``LM._apply_block`` on a layer without MoE)."""
    from repro_torch.models.attention import attention_block
    from repro_torch.models.layers import apply_mlp, apply_norm
    h = attention_block(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                        positions, use_flash)
    x = x + h
    return x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)


def stacked_blocks(torch, blocks) -> dict:
    """The parameters of ``blocks`` stacked on a leading [n_stages] axis, as
    a plain tree of the blocks' parameter names."""
    first = blocks[0]
    return {sub: {k: torch.stack([b._modules[sub][k].detach()
                                  for b in blocks])
                  for k in first._modules[sub].keys()}
            for sub in first._modules}


class Smoke:
    """The phases, sharing the port's modules, the card and what earlier
    phases measured."""

    def __init__(self, torch):
        self.torch = torch
        sys.path.insert(0, str(ROOT / "src"))
        import repro_torch.core.netsim as T
        from repro_torch.kernels.netsim_tick import kernel as K
        from repro_torch.kernels.netsim_tick import ref as Rf
        from repro_torch.kernels.netsim_tick import tiled as Tl
        from repro_torch.kernels.netsim_tick import window as Wn
        from repro_torch.kernels import switch_pipeline as Sp
        from repro_torch.kernels import flash_attention as Fa
        from repro_torch.kernels import ssd as Sd
        self.T, self.K, self.Rf, self.Wn, self.Tl, self.Sp, self.Fa = \
            T, K, Rf, Wn, Tl, Sp, Fa
        self.Sd = Sd
        self.dev = torch.device("cuda")
        self.card = "nvidia-smi unavailable"
        self.mid = {}           # (shape, ecmp) -> (ctx, cfg, state, tick)
        self.max_err = {"netsim_tick": 0.0, "netsim_window": 0.0,
                        "netsim_tiled": 0.0, "switch_pipeline": 0.0,
                        "flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
                        "ssd": 0.0}
        self.danube = None      # the full-width model of prefill and serve
        self.mamba_lm = None    # the full-width model of ssd and mamba
        self.granite = None     # the full-width model of moe
        self.jamba_lm = None    # jamba's first period, of the jamba phase
        self.launches = {}
        self.rates = {}
        self.reports = []
        self.eager128 = None
        self.against = None     # --against: {library: another commit's csrc}
        self.launch_futs = {}   # launch_task futures, started with the run
        self.launch_pool = None
        self.golden_futs = {}   # golden_task futures (start_goldens)
        self.golden_pool = None
        self.launch_t0 = None
        self.launch_done = []   # their finishing times
        self.variants = {}      # tag -> a library built from edited sources

    # ---------------------------------------------------------- 1. build
    def build(self):
        from repro_torch.kernels import _build
        torch = self.torch
        t0 = time.time()
        libs = _build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        if smi.stdout.strip():
            self.card = smi.stdout.strip().splitlines()[0]
        for name, (_, log) in libs.items():
            for line in log.splitlines():   # C75xx: wgmma serialized
                if "registers" in line or "spill" in line or "C75" in line:
                    say("build", f"{name}: {line.strip()}")
        say("build", f"{', '.join(libs)} built in {time.time() - t0:.1f} s "
                     "(in parallel)")
        Fa = self.Fa
        # (kernel, template arguments after the head dim, info)
        for kname, targs, info_of in (
                ("flash_fwd_bf16", "", lambda dp: Fa.fwd_kernel_info(
                    torch.bfloat16, dp)),
                ("flash_fwd_f32", "", lambda dp: Fa.fwd_kernel_info(
                    torch.float32, dp)),
                ("flash_dq_bf16", "", lambda dp: Fa.bwd_kernel_info(
                    "dq", torch.bfloat16, dp)),
                ("flash_dkv_bf16", "", lambda dp: Fa.bwd_kernel_info(
                    "dkv", torch.bfloat16, dp))):
            for dp in (64, 128):
                info = info_of(dp)
                moved = (" (setmaxnreg moves them between warpgroups)"
                         if "bf16" in kname else "")
                say("build", f"{kname[:9]}: {kname}<{dp}{targs}>: "
                             f"{info['registers']} registers a thread at "
                             f"launch{moved}, {info['local_bytes']} bytes of "
                             f"local memory (spills), {info['smem_bytes']:,} "
                             f"bytes of dynamic shared memory, "
                             f"{info['threads']} threads")
                if info["local_bytes"]:
                    fail("build", f"{kname}<{dp}{targs}> spills to local "
                                  "memory")
        self.netsim_build_report(libs)
        self.ssd_build_report(libs)
        self.scan_build_report(libs)
        print(self.card, flush=True)
        from repro_torch.core.netsim.stages import ordered_segment_sum
        g = torch.Generator().manual_seed(0)
        idx = torch.randint(0, 97, (2, 8192), generator=g)
        vals = torch.rand(2, 8192, generator=g) * 1e9
        base = torch.rand(2, 97, generator=g)
        dev = self.dev
        if not torch.equal(ordered_segment_sum(base, idx, vals),
                           ordered_segment_sum(base.to(dev), idx.to(dev),
                                               vals.to(dev)).cpu()):
            fail("build", "ordered_segment_sum on the card differs from the "
                          "CPU order")
        say("build", "ordered_segment_sum on the card equals the CPU order")

    def netsim_build_report(self, libs):
        """Registers, stack, spills and shared memory of the tick and
        window kernels, each instantiation (link ids in shared or in global
        memory), from ptxas's report; fails on a spill."""
        from repro_torch.kernels import _build
        K, Wn = self.K, self.Wn
        for lib in ("netsim_tick", "netsim_window"):
            entries = _build.ptxas_entries(libs[lib][1])
            for ids_smem, shape in ((True, "multipod128"),
                                    (False, "multipod512")):
                F, FW, H, L1, J, DJ = NETSIM_DIMS[shape]
                split = K.hot_smem_split(FW, H, L1, J, DJ) \
                    if lib == "netsim_tick" else \
                    Wn.window_smem_split(F, FW, H, L1, J, DJ)
                if (split.ids == 0) != ids_smem:
                    fail("build", f"{lib} at {shape}: ids in "
                                  f"{'global' if split.ids else 'shared'} "
                                  "memory, not as expected")
                tag = f"{lib}_kernelILb{int(ids_smem)}E"
                found = [v for k, v in entries.items() if tag in k]
                if len(found) != 1:
                    fail("build", f"no ptxas report of {tag} in the build "
                                  "log")
                e = found[0]
                say("build", f"{lib}_kernel<IDS_SMEM={str(ids_smem).lower()}>"
                             f": {e['registers']} registers a thread, "
                             f"{e['stack']} bytes of stack frame, "
                             f"{e['spill_stores']} / {e['spill_loads']} "
                             f"bytes of spill stores / loads, "
                             f"{e['smem']} bytes of static and "
                             f"{split.smem:,} of dynamic shared memory and "
                             f"{split.ws:,} bytes of global workspace a "
                             f"lane at {shape}")
                if e["spill_stores"] or e["spill_loads"]:
                    fail("build", f"{lib}_kernel<{ids_smem}> spills to "
                                  "local memory")

    def scan_build_report(self, libs):
        """Registers, stack, spills and shared memory of the tiled tick's
        five kernels and the switch pipeline's scan, from ptxas's report,
        with the tiled tick's dynamic shared memory at each shape it runs
        at; fails on a spill or on a kernel missing from the report."""
        from repro_torch.kernels import _build
        smem = {shape: self.Tl.tiled_smem_bytes(L1, J, DJ)
                for shape, (_, _, _, L1, J, DJ) in NETSIM_DIMS.items()}
        for lib, names in (("netsim_tiled", ("tiled_sweep0", "tiled_sweep1",
                                             "tiled_sweep2", "tiled_sweep3",
                                             "tiled_flush")),
                           ("switch_pipeline", ("switch_pipeline_kernel",))):
            entries = _build.ptxas_entries(libs[lib][1])
            for kname in names:
                found = [e for m, e in entries.items() if kname in m]
                if len(found) != 1:
                    fail("build", f"no ptxas report of {kname} in the "
                                  f"{lib} build log")
                e = found[0]
                dyn = (f", the most dynamic shared memory a sweep takes: "
                       + ", ".join(f"{v:,} bytes at {k}"
                                   for k, v in smem.items())
                       if kname == "tiled_sweep0" else "")
                say("build", f"{lib}: {kname}: {e['registers']} registers a "
                             f"thread, {e['stack']} bytes of stack frame, "
                             f"{e['spill_stores']} / {e['spill_loads']} bytes "
                             f"of spill stores / loads, {e['smem']:,} bytes of"
                             f" static shared memory{dyn}")
                if e["spill_stores"] or e["spill_loads"]:
                    fail("build", f"{kname} spills to local memory")

    def variant(self, lib: str, tag: str, edits=(), csrc=None):
        """Library ``lib`` built from a copy of its csrc directory (or of
        ``csrc``, another commit's) with ``edits`` applied, each ``(file,
        old, new)`` with ``old`` found exactly once, under the git-ignored
        build/chip_smoke_variants/``tag``; bound like the shipped one."""
        from repro_torch.kernels import _build
        if tag in self.variants:
            return self.variants[tag]
        src = Path(csrc) if csrc else _build._REGISTRY[lib].csrc
        out = ROOT / "build" / "chip_smoke_variants" / tag
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(src, out, ignore=shutil.ignore_patterns("build"))
        for fname, old, new in edits:
            text = (out / fname).read_text()
            if text.count(old) != 1:
                fail("build", f"variant {tag}: {old!r} is not in {fname} "
                              "exactly once")
            (out / fname).write_text(text.replace(old, new))
        so = out / f"{lib}.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(out / f"{lib}.cu")], capture_output=True, text=True)
        if proc.returncode:
            fail("build", f"nvcc failed on variant {tag}:\n"
                          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        self.variants[tag] = ctypes.CDLL(str(so))
        return self.variants[tag]

    @contextlib.contextmanager
    def using(self, lib: str, cdll):
        """Run library ``lib``'s wrapper with ``cdll`` in place of its own
        library (a variant of the same interface, bound here)."""
        from repro_torch.kernels import _build
        _build._REGISTRY[lib].bind(cdll)
        own = _build.build(lib)[0]
        _build._loaded[lib] = cdll
        try:
            yield
        finally:
            _build._loaded[lib] = own

    def ssd_build_report(self, libs):
        """Registers, stack, spills and shared memory of every kernel of the
        SSD library (the chunk-state and output kernels once for float32
        and once for bf16 B/C) from ptxas's report, with the dynamic shared
        memory the library's ``ssd_smem_bytes`` gives; fails on a spill or
        on a kernel missing from the report."""
        import re
        from repro_torch.kernels import _build
        SK = self.Sd.kernel
        lib, log = libs["ssd"]
        entries = _build.ptxas_entries(log)
        bc_dtypes = {"f": 0, "13__nv_bfloat16": 1}
        for k, kname in enumerate(SK.KERNELS):
            found = {m: e for m, e in entries.items() if kname in m}
            if not found:
                fail("build", f"no ptxas report of {kname} in the SSD build "
                              "log")
            for mangled, e in sorted(found.items()):
                m = re.search(kname + r"I(\w+?)EEv", mangled)
                targ = m.group(1) if m else ""
                dyn = lib.ssd_smem_bytes(k, bc_dtypes.get(targ, 0))
                targ = {"f": "float"}.get(targ, re.sub(r"^\d+", "", targ))
                say("build", f"ssd: {kname}<{targ or '-'}>: "
                             f"{e['registers']} registers a thread, "
                             f"{e['stack']} bytes of stack frame, "
                             f"{e['spill_stores']} / {e['spill_loads']} bytes "
                             f"of spill stores / loads, {e['smem']} bytes of "
                             f"static and {dyn:,} of dynamic shared memory, "
                             f"{SK.THREADS} threads")
                if e["spill_stores"] or e["spill_loads"] or e["stack"]:
                    fail("build", f"{kname}<{targ}> spills to local memory")

    # ----------------------------------------------------------- 2. math
    def math(self):
        """The window kernel calls expf on -lam (lam >= 0, the expected
        marks of a DCQCN epoch) and on the summed log no-mark terms
        (>= H * log1p(-0.999999) ~ -83), and log1pf on -p_hop with p_hop in
        [0, 0.999999]; the eager tick calls torch's exp/log1p there."""
        torch, dev = self.torch, self.dev
        n = 1 << 22
        cases = {
            "exp": torch.linspace(-100.0, 0.0, n, device=dev),
            "log1p": -torch.linspace(0.0, 0.999999, n, device=dev),
        }
        for name, x in cases.items():
            e, lp = self.Wn.kernel_math(x.contiguous())
            mine = e if name == "exp" else lp
            ref = torch.exp(x) if name == "exp" else torch.log1p(x)
            ulp = (mine.view(torch.int32).long() -
                   ref.view(torch.int32).long()).abs()
            if not torch.isfinite(mine).all():
                fail("math", f"kernel {name} gave non-finite values")
            say("math", f"{name}: kernel vs torch on {n} points in the tick's "
                        f"range: {int((ulp != 0).sum())} differ, max "
                        f"{int(ulp.max())} ulp")
            if int(ulp.max()) > 2:
                fail("math", f"kernel {name} is {int(ulp.max())} ulp off")

    def mid_state(self, shape: str, ecmp: bool):
        """A mid-run engine state (``WARM`` eager ticks) of the 4-knob-point
        lanes: Table 1 x 1 seed, or a multipod grid x 2 seeds."""
        key = (shape, ecmp)
        if key not in self.mid:
            T, torch = self.T, self.torch
            from repro_torch.core.netsim.stages import engine_tick_eager
            topo, wl, cfg = SHAPES[shape](T)
            seeds = [0] if shape == "table1" else [0, 1]
            ctx, ecfg, sim = T.make_lanes(
                topo, wl, cfg._replace(backend="cuda").structure(),
                lane_knobs(T, cfg), seeds=seeds,
                routing="ecmp" if ecmp else "ecmp_flow", device=self.dev)
            state = sim.engine
            with torch.no_grad():
                for tick in range(WARM):
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                 False)
            self.mid[key] = (ctx, ecfg, state, WARM)
        return self.mid[key]

    def compare(self, phase, what, x, y, rtol=RTOL, kernel=None) -> float:
        """Fail unless ``x`` equals ``y`` (integers) or is allclose at
        ``rtol``; returns the max abs error."""
        torch = self.torch
        if x.dtype in (torch.int32, torch.int64):
            if not torch.equal(x, y):
                fail(phase, f"{what} differs")
            return 0.0
        err = (x - y).abs().max().item() if x.numel() else 0.0
        if kernel:
            self.max_err[kernel] = max(self.max_err[kernel], err)
        if not torch.isfinite(x).all() or \
                not torch.allclose(x, y, rtol=rtol, atol=0.0):
            fail(phase, f"{what}: max abs err {err}")
        return err

    def entry_stats(self, ctx, args, out) -> tuple[int, int, int]:
        """``(active instances, longest link-row segment, longest
        Symphony-row segment)`` of a tick, the most over its lanes: the
        sizes the tick and window kernels' row sorts and walks see."""
        torch = self.torch
        step, sent, _, done_upto = args[:4]
        job, flow = ctx.inst_job.long(), ctx.inst_flow.long()
        sched = ctx.wl.chunk_sched
        iseg = torch.div(step, ctx.sps_i, rounding_mode="floor") * \
            ctx.nph_i + ctx.phase_i
        chunk = sched[job, iseg.clamp(0, sched.shape[1] - 1)]
        occupied = step >= 0
        active = occupied & (sent < chunk) & ~(step < done_upto[:, flow])
        links = out.iroute.long()                       # [B, FW, H]
        dj = ctx.st.link_dom.gather(1, links.reshape(ctx.B, -1)).reshape(
            links.shape).long() * ctx.J + job[None, :, None]
        lane = torch.arange(ctx.B, device=step.device)[:, None, None]
        keep = active[..., None].expand_as(links)
        L1 = ctx.L + 1
        lrow = torch.bincount((links + lane * L1)[keep],
                              minlength=ctx.B * L1)
        srow = torch.bincount((dj + lane * ctx.DJ)[keep],
                              minlength=ctx.B * ctx.DJ)
        return (int(active.sum(1).max()), int(lrow.max()), int(srow.max()))

    def bits_differ(self, x, y) -> int:
        """Elements of two float32 tensors whose bits differ (0 for
        integer tensors, which compare() holds exactly)."""
        if x.dtype != self.torch.float32:
            return 0
        i32 = self.torch.int32
        return int((x.view(i32) != y.view(i32)).sum())

    # -------------------------------------------- 3. tick kernel vs plain
    def kernel(self):
        torch, K, Rf = self.torch, self.K, self.Rf
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tick_operands
        for shape in ("table1", "multipod128"):
            for ecmp in (True, False):
                ctx, ecfg, state, t0 = self.mid_state(shape, ecmp)
                self.check_dims("kernel", ctx, shape)
                bits = {}
                stats = (0, 0, 0)
                with torch.no_grad():
                    for tick in range(t0, t0 + 10):
                        starts = stage_starts(ctx, state, tick)
                        args, kw = tick_operands(ctx, ecfg, starts, state,
                                                 tick)
                        out = K.netsim_tick(*args, **kw)
                        ref = Rf.hot_tick(*args, **kw)
                        torch.cuda.synchronize()
                        for f in out._fields:
                            self.compare("kernel", f"{shape} ecmp={ecmp} "
                                         f"tick {tick}: {f}", getattr(out, f),
                                         getattr(ref, f),
                                         kernel="netsim_tick")
                        self.count_bits(bits, out, ref)
                        stats = tuple(map(max, stats, self.entry_stats(
                            ctx, args, ref)))
                        state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                     False)
                active = int((starts.step_of >= 0).sum())
                say("kernel", f"{shape} lanes={ctx.B} per_step_ecmp={ecmp}: "
                              f"ticks {t0}-{t0 + 9} equal (ints exact, "
                              f"floats rtol {RTOL}); {active} occupied "
                              f"instances; a tick's most: {stats[0]} active "
                              f"instances a lane of {ctx.FW}, longest link-"
                              f"row segment {stats[1]}, longest Symphony-row "
                              f"segment {stats[2]}")
                self.say_bits("kernel", shape, bits)
        say("kernel", "max abs float error kernel vs plain: "
                      f"{self.max_err['netsim_tick']}")

    def check_dims(self, phase, ctx, shape):
        """The builders give a shape the dimensions NETSIM_DIMS says."""
        if shape in NETSIM_DIMS and NETSIM_DIMS[shape] != (
                ctx.F, ctx.FW, ctx.H, ctx.L + 1, ctx.J, ctx.DJ):
            fail(phase, f"{shape}: dimensions differ from NETSIM_DIMS")

    def count_bits(self, bits, out, ref):
        """Add each float field's count of bit-differing elements."""
        for f in out._fields:
            bits[f] = bits.get(f, 0) + self.bits_differ(getattr(out, f),
                                                        getattr(ref, f))

    def say_bits(self, phase, what, bits):
        say(phase, f"{what}: float elements whose bits differ from the "
                   "plain version, summed over the checked ticks: "
                   + ", ".join(f"{f} {n}" for f, n in bits.items()
                               if f in FLOAT_OUTPUTS))

    # ------------------------------------------ 4. window kernel vs plain
    def window(self):
        torch, Rf, Wn = self.torch, self.Rf, self.Wn
        state_err = 0.0
        for shape in ("table1", "multipod128"):
            for ecmp in (True, False):
                ctx, ecfg, state, base = self.mid_state(shape, ecmp)
                for n in (20, 7):
                    kst, ksm = Wn.netsim_window(ctx, ecfg, state, base, n)
                    rst, rsm = Rf.window_ref(ctx, ecfg, state, base, n)
                    torch.cuda.synchronize()
                    what = f"{shape} ecmp={ecmp} ticks {base}-{base + n - 1}"
                    for f in kst._fields:
                        state_err = max(state_err, self.compare(
                            "window", f"{what}: state {f}", getattr(kst, f),
                            getattr(rst, f), kernel="netsim_window"))
                    names = ("min_wire", "max_wire", "done_min", "throughput",
                             "qmax", "alpha_max")
                    for f, x, y in zip(names, ksm, rsm):
                        self.compare("window", f"{what}: sample {f}", x, y,
                                     rtol=RTOL_TPUT if f == "throughput"
                                     else RTOL, kernel="netsim_window")
                    state, base = rst, base + n
                say("window", f"{shape} lanes={ctx.B} per_step_ecmp={ecmp}: "
                              "windows of 20 and 7 ticks equal the plain "
                              f"version (ints and alpha exact, floats rtol "
                              f"{RTOL}, throughput rtol {RTOL_TPUT})")
        say("window", "max abs float error kernel vs plain: "
                      f"{self.max_err['netsim_window']} (state alone: "
                      f"{state_err}; the rest is the throughput sample)")

    # ------------------------------------------- 5. tiled kernel vs plain
    def tiled(self):
        torch, Tl, Rf = self.torch, self.Tl, self.Rf
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tiled_operands
        # each shape's main-path tile; at Table 1 also a tile that does not
        # divide FW (a ragged last block) and one block of the whole axis
        # (the untiled onehot tick)
        runs = [(shape, BLK[shape], ecmp)
                for shape in ("table1", "multipod128", "multipod512")
                for ecmp in (True, False)]
        runs += [("table1", 300, True), ("table1", 2048, True)]
        for shape, blk, ecmp in runs:
            ctx, ecfg, state, t0 = self.mid_state(shape, ecmp)
            n = 10 if shape != "multipod512" else 5
            bits = {}
            with torch.no_grad():
                for tick in range(t0, t0 + n):
                    starts = stage_starts(ctx, state, tick)
                    args, kw = tiled_operands(ctx, ecfg, starts, state,
                                              tick, blk)
                    out = Tl.netsim_tiled(*args, **kw)
                    ref = Rf.tiled_tick_ref(*args, **kw)
                    torch.cuda.synchronize()
                    for f in out._fields:
                        self.compare("tiled", f"{shape} blk={blk} "
                                     f"ecmp={ecmp} tick {tick}: {f}",
                                     getattr(out, f), getattr(ref, f),
                                     kernel="netsim_tiled")
                    self.count_bits(bits, out, ref)
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                 False)
            if any(bits.values()):
                self.say_bits("tiled", f"{shape} blk={blk}", bits)
                fail("tiled", f"{shape} blk={blk} ecmp={ecmp}: float outputs"
                              " differ from the plain version in their bits")
            nb = -(-ctx.FW // blk)
            smem = Tl.tiled_smem_bytes(ctx.L + 1, ctx.J, ctx.DJ)
            if smem > self.K.SMEM_LIMIT:
                fail("tiled", f"{shape}: {smem} bytes of shared memory a "
                              "block")
            # act list and the two sorted lists (uint16), both offsets
            lists = ctx.B * nb * (2 * blk * (1 + 2 * ctx.H) +
                                  4 * (ctx.L + ctx.DJ + 2))
            say("tiled", f"{shape} lanes={ctx.B} blk={blk} ({nb} blocks"
                         f" of {ctx.FW} instances) per_step_ecmp={ecmp}:"
                         f" ticks {t0}-{t0 + n - 1} equal the plain "
                         f"version bit for bit; {smem:,} bytes of shared "
                         f"memory a block at most (limit "
                         f"{self.K.SMEM_LIMIT:,}), {lists:,} bytes of row "
                         "lists")
        say("tiled", "max abs float error kernel vs plain: "
                     f"{self.max_err['netsim_tiled']}")
        self.tiled_fault()

    def tiled_fault(self):
        """A planted fault: the row sort's placement ranks the entries of a
        32-entry batch that share a row in reverse, so rows fold in
        another order.  On the ticks the tiled phase checks, at Table 1
        and at 512 hosts, some float output must differ from the plain
        version's bits."""
        torch, Tl, Rf = self.torch, self.Tl, self.Rf
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tiled_operands
        lib = self.variant("netsim_tiled", "tiled_misordered_sort", [(
            "netsim_hot.cuh", "const int rank = __popc(peers & lt);",
            "const int rank = __popc(peers) - 1 - __popc(peers & lt);")])
        for shape in ("table1", "multipod512"):
            ctx, ecfg, state, t0 = self.mid_state(shape, True)
            blk, bits = BLK[shape], {}
            saved = Tl.netsim_tiled.launches
            with torch.no_grad(), self.using("netsim_tiled", lib):
                for tick in range(t0, t0 + 5):
                    starts = stage_starts(ctx, state, tick)
                    args, kw = tiled_operands(ctx, ecfg, starts, state,
                                              tick, blk)
                    out = Tl.netsim_tiled(*args, **kw)
                    ref = Rf.tiled_tick_ref(*args, **kw)
                    self.count_bits(bits, out, ref)
                    state, _ = engine_tick_eager(ctx, ecfg, state, tick,
                                                 False)
            Tl.netsim_tiled.launches = saved
            if not any(bits.values()):
                fail("tiled", f"planted fault (misordered row sort) passes "
                              f"the bit check at {shape}")
            self.say_bits("tiled", f"planted fault (misordered row sort), "
                                   f"{shape} blk={blk}, ticks {t0}-{t0 + 4},"
                                   " failing the check", bits)

    # ------------------------- 6. tick and window kernels at 256-512 hosts
    def large(self):
        torch, K, Rf, Wn = self.torch, self.K, self.Rf, self.Wn
        from repro_torch.core.netsim.stages import (engine_tick_eager,
                                                    stage_starts)
        from repro_torch.kernels.netsim_tick.ops import tick_operands
        for shape in ("multipod256", "multipod512"):
            ctx, ecfg, state, t0 = self.mid_state(shape, True)
            split = Wn.window_smem_split(ctx.F, ctx.FW, ctx.H, ctx.L + 1,
                                         ctx.J, ctx.DJ)
            if not split.ids:
                fail("large", f"{shape}: expected the link ids in global "
                              "memory")
            self.check_dims("large", ctx, shape)
            tick_state = state
            bits, wbits = {}, {}
            stats = (0, 0, 0)
            with torch.no_grad():
                for tick in range(t0, t0 + 3):
                    starts = stage_starts(ctx, tick_state, tick)
                    args, kw = tick_operands(ctx, ecfg, starts, tick_state,
                                             tick)
                    out = K.netsim_tick(*args, **kw)
                    ref = Rf.hot_tick(*args, **kw)
                    torch.cuda.synchronize()
                    for f in out._fields:
                        self.compare("large", f"{shape} tick {tick}: {f}",
                                     getattr(out, f), getattr(ref, f),
                                     kernel="netsim_tick")
                    self.count_bits(bits, out, ref)
                    stats = tuple(map(max, stats, self.entry_stats(
                        ctx, args, ref)))
                    tick_state, _ = engine_tick_eager(ctx, ecfg, tick_state,
                                                      tick, False)
            say("large", f"{shape}: a tick's most: {stats[0]} active "
                         f"instances a lane of {ctx.FW}, longest link-row "
                         f"segment {stats[1]}, longest Symphony-row segment "
                         f"{stats[2]}")
            self.say_bits("large", f"{shape} tick kernel", bits)
            base = t0
            for n in (20, 7):
                kst, ksm = Wn.netsim_window(ctx, ecfg, state, base, n)
                rst, rsm = Rf.window_ref(ctx, ecfg, state, base, n)
                torch.cuda.synchronize()
                what = f"{shape} ticks {base}-{base + n - 1}"
                for f in kst._fields:
                    self.compare("large", f"{what}: state {f}",
                                 getattr(kst, f), getattr(rst, f),
                                 kernel="netsim_window")
                self.count_bits(wbits, kst, rst)
                for i, (x, y) in enumerate(zip(ksm, rsm)):
                    self.compare("large", f"{what}: sample {i}", x, y,
                                 rtol=RTOL_TPUT if i == 3 else RTOL,
                                 kernel="netsim_window")
                state, base = rst, base + n
            say("large", f"{shape} lanes={ctx.B} (FW={ctx.FW}, L+1="
                         f"{ctx.L + 1}): link ids in {split.ids} bytes of "
                         f"global memory a lane, {split.smem} bytes of shared"
                         f" memory; tick kernel ticks {t0}-{t0 + 2} and "
                         f"windows of 20 and 7 equal the plain versions")
            self.say_bits("large", f"{shape} window kernel (state)", wbits)

    # -------------------------------------------------- 7. switch pipeline
    def switch_trace(self, n: int, seed: int):
        """A packet trace like tests/test_kernels.py's, on the card."""
        import numpy as np
        rng = np.random.default_rng(seed)
        steps = np.maximum(0, rng.integers(0, 4, n) + np.arange(n) // 200)
        arrays = (steps.astype(np.int32),
                  rng.integers(1, 5000, n).astype(np.float32),
                  (rng.random(n) < 0.02).astype(np.int32),
                  (np.arange(n) % 100 == 99).astype(np.int32),
                  rng.random(n).astype(np.float32))
        return [self.torch.from_numpy(a).to(self.dev) for a in arrays]

    def switch_check(self, what, out, ref, kernel="switch_pipeline"):
        """Fail unless the four outputs equal the plain version's bit for
        bit; ``kernel``: whose max error to record (None: none)."""
        torch = self.torch
        for name, x, y in zip(("marks", "step_min", "psn_rec", "alpha"),
                              out, ref):
            self.compare("switch", f"{what}: {name}", x, y, kernel=kernel)
            if self.bits_differ(x, y):
                fail("switch", f"{what}: {name} differs in its bits")

    def switch_differs(self, out, ref) -> bool:
        torch = self.torch
        return any(not torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(out, ref))

    def switch_saturation(self):
        """A trace whose counts pass 2^24: 2^20 packets at the step_min,
        then 2^24 outpacing it, one window end at the last packet, tau 1.
        The walk's float32 counts stop at 2^24, so that window sees cnt =
        cnt_op = 2^24 and alpha steps up to 2 (unsaturated counts would
        step it down).  Returns (inputs, kw, expected outputs): the state
        before and after each packet in closed form, the marks from it by
        the plain version's own ``outputs_from_states``."""
        torch, dev = self.torch, self.dev
        Sr = self.Sp.ref
        n0, P = 1 << 20, (1 << 24) + (1 << 20)
        g = torch.Generator(device=dev).manual_seed(5)
        steps = (torch.arange(P, device=dev) >= n0).to(torch.int32)
        psns = torch.full((P,), 100.0, device=dev)
        lasts = torch.zeros(P, dtype=torch.int32, device=dev)
        wins = torch.zeros(P, dtype=torch.int32, device=dev)
        wins[-1] = 1
        us = torch.rand(P, generator=g, device=dev)
        kw = dict(tau=1.0)
        zero = torch.zeros(P, device=dev)
        prec_post = torch.full((P,), 100.0, device=dev)
        prec_post[-1] = 0.0
        prec_pre = torch.cat([zero[:1], prec_post[:-1]])
        alpha_post = torch.ones(P, device=dev)
        alpha_post[-1] = 2.0
        pre = torch.stack([zero, prec_pre, torch.ones(P, device=dev)])
        post = torch.stack([zero, prec_post, alpha_post])
        want = Sr.outputs_from_states(steps, psns, us, pre, post)
        return (steps, psns, lasts, wins, us), kw, want

    def switch(self):
        torch, Sp = self.torch, self.Sp
        small = self.switch_trace(8000, 7)
        for exact in (True, False):
            saved = Sp.switch_pipeline.launches
            out = Sp.switch_pipeline(*small, exact=exact)
            Sp.switch_pipeline.launches = saved
            ref = Sp.pipeline_plain(*small, exact=exact)
            torch.cuda.synchronize()
            self.switch_check(f"P=8000 exact={exact}", out, ref)
            say("switch", f"P=8000 exact={exact}: kernel equals the plain "
                          f"version bit for bit; {int(out[0].sum())} marks")
        # the scan's edge cases on the kernel's tile edges
        traces = {name: ([torch.from_numpy(x).to(self.dev) for x in arrays],
                         kw)
                  for name, (arrays, kw) in
                  Sp.ref.scan_traces(Sp.kernel.TILE).items()}
        saved = Sp.switch_pipeline.launches
        plain = {}
        for name, (trace, kw) in traces.items():
            for exact in (True, False):
                out = Sp.switch_pipeline(*trace, exact=exact, **kw)
                plain[name, exact] = Sp.pipeline_plain(*trace, exact=exact,
                                                       **kw)
                self.switch_check(f"{name} exact={exact}", out,
                                  plain[name, exact])
        sat, sat_kw, sat_want = self.switch_saturation()
        self.switch_check(f"counts past 2^24 (P={sat[0].numel()})",
                          Sp.switch_pipeline(*sat, **sat_kw), sat_want)
        Sp.switch_pipeline.launches = saved
        say("switch", f"tile {Sp.kernel.TILE}: edge traces "
                      f"{', '.join(traces)} (both marking paths) and a "
                      f"{sat[0].numel():,}-packet trace whose counts pass "
                      "2^24 equal the plain version bit for bit")
        # the main path: the entry point on a 1,000,000-packet trace
        big = self.switch_trace(1_000_000, 11)
        Sp.switch_pipeline.launches = 0
        t0 = time.time()
        ex = Sp.switch_pipeline(*big, exact=True)
        lut = Sp.switch_pipeline(*big, exact=False)
        torch.cuda.synchronize()
        secs = time.time() - t0
        self.launches["switch_pipeline"] = Sp.switch_pipeline.launches
        if Sp.switch_pipeline.launches != 2:
            fail("switch", f"{Sp.switch_pipeline.launches} launches for two "
                           "calls")
        for x, y in zip(ex[1:], lut[1:]):
            if not torch.equal(x, y):
                fail("switch", "the state trajectory depends on the marking "
                               "path")
        if not all(torch.isfinite(x).all() for x in ex[2:]):
            fail("switch", "non-finite state")
        re, rl = ex[0].float().mean().item(), lut[0].float().mean().item()
        if not abs(re - rl) < 0.02 + 0.25 * re:
            fail("switch", f"LUT mark rate {rl} vs exact {re}")
        t1 = time.time()
        for exact, out in ((True, ex), (False, lut)):
            self.switch_check(f"P=1e6 exact={exact}", out,
                              Sp.pipeline_plain(*big, exact=exact))
        say("switch", f"P=1,000,000: both paths in {secs:.4f} s (2 "
                      f"launches), mark rate exact {re:.4f}, LUT {rl:.4f}, "
                      "same state trajectory; all 1,000,000 packets of both "
                      "paths equal the plain version bit for bit (its host "
                      f"walks took {time.time() - t1:.1f} s)")
        self.switch_faults(big, (ex, lut), traces, plain, sat, sat_kw,
                           sat_want)

    def switch_faults(self, big, big_out, traces, plain, sat, sat_kw,
                      sat_want):
        """Planted faults, each a variant of the kernel's source that must
        fail the checks above: a look-back that skips the nearest
        predecessor (on the 1,000,000-packet trace and the edge traces),
        and counts that do not saturate (on the trace past 2^24)."""
        Sp = self.Sp
        src = "switch_pipeline.cu"
        faults = (
            ("look-back skips the nearest predecessor",
             [(src, "const int first = tile - 1;",
               "const int first = tile > 1 ? tile - 2 : tile - 1;")]),
            ("counts without saturation",
             [(src, "__device__ __forceinline__ int sat(int n) { return "
                    "min(n, SP_SAT); }",
               "__device__ __forceinline__ int sat(int n) { return n; }")]))
        saved = Sp.switch_pipeline.launches
        caught = []
        for k, (fault, edits) in enumerate(faults):
            lib = self.variant("switch_pipeline", f"switch_fault{k}", edits)
            where = []
            with self.using("switch_pipeline", lib):
                for exact, want in zip((True, False), big_out):
                    if self.switch_differs(
                            Sp.switch_pipeline(*big, exact=exact), want):
                        where.append(f"P=1e6 exact={exact}")
                for (name, exact), want in plain.items():
                    trace, kw = traces[name]
                    if self.switch_differs(Sp.switch_pipeline(
                            *trace, exact=exact, **kw), want):
                        where.append(name)
                if self.switch_differs(Sp.switch_pipeline(*sat, **sat_kw),
                                       sat_want):
                    where.append("counts past 2^24")
            if not where:
                fail("switch", f"planted fault passes every check: {fault}")
            caught.append(f"{fault}: fails on {', '.join(where)}")
        Sp.switch_pipeline.launches = saved
        say("switch", "planted faults, each failing the check: "
                      + "; ".join(caught))

    # -------------------------------------------- 8. flash kernel vs plain
    def attn_inputs(self, B, Hq, Hkv, S, D, dtype, seed=0):
        """q [B, S, Hq, D], k/v [B, S, Hkv, D] on the card, from numpy."""
        import numpy as np
        rng = np.random.default_rng(seed)
        return [self.torch.from_numpy(
                    rng.standard_normal((B, S, h, D), np.float32)).to(
                    self.dev, getattr(self.torch, dtype))
                for h in (Hq, Hkv, Hkv)]

    def attn_close(self, o, lse, o_ref, l_ref, tol_o, tol_l):
        """(ok, max abs error of o, message): o and lse against their plain
        versions at the reference's tolerances and at ROW_TOL / LSE_ABS."""
        torch = self.torch
        eo = (o.float() - o_ref.float()).abs().max().item()
        er = row_err(o, o_ref)
        el = (lse - l_ref).abs().max().item()
        ok = bool(torch.isfinite(o).all() and torch.isfinite(lse).all()
                  and torch.allclose(o.float(), o_ref.float(), atol=tol_o,
                                     rtol=tol_o)
                  and torch.allclose(lse, l_ref, atol=tol_l, rtol=tol_l)) \
            and er <= ROW_TOL and el <= LSE_ABS
        return ok, eo, f"o {eo:.3g} (row {er:.3g}) lse {el:.3g}"

    def flash(self):
        Fa = self.Fa
        shapes = [(f"BH={bh} group={g} S={S} D={D} window={w}", 1, bh,
                   bh // g, S, D, w) for bh, g, S, D, w in FLASH_CASES]
        shapes += [(f"danube heads 32/8 D=120 S={FLASH_S} window={w}", 1, 32,
                    8, FLASH_S, 120, w) for w in (1024, 8192)]
        shapes += [(f"{name} heads {hq}/{hkv} D={D} B={B} S={S} causal", B,
                    hq, hkv, S, D, 0)
                   for name, B, hq, hkv, S, D in FAMILY_FLASH.values()]
        saved = Fa.flash_fwd.launches
        for name, B, hq, hkv, S, D, w in shapes:
            for dtype, (tol_o, tol_l) in FLASH_TOL.items():
                q, k, v = self.attn_inputs(B, hq, hkv, S, D, dtype)
                flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                        for x in (q, k, v)]
                # the plain version in float32 on the same values
                o_ref, l_ref = Fa.attention_ref(*(x.float() for x in flat),
                                                window=w)
                o3, l3 = Fa.flash_fwd(*flat, window=w)
                again = Fa.flash_fwd(*flat, window=w)
                # strided [B, H, S, D] views of [B, S, H, D]: no copy
                o4, l4 = Fa.flash_fwd(*(x.transpose(1, 2) for x in (q, k, v)),
                                      window=w)
                self.torch.cuda.synchronize()
                self.same_bits(f"{name} {dtype}", (o3, l3), again)
                errs = []
                for layout, o, lse in (("[BH,S,D]", o3, l3),
                                       ("[B,S,H,D] view", o4.reshape(-1, S, D),
                                        l4.reshape(-1, S))):
                    ok, eo, msg = self.attn_close(o, lse, o_ref, l_ref, tol_o,
                                                  tol_l)
                    errs.append(f"{layout} {msg}")
                    self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"],
                                                    eo)
                    if not ok:
                        fail("flash", f"{name} {dtype} {layout}: {msg}")
                say("flash", f"{name} {dtype}: max abs err {'; '.join(errs)}"
                             f" (tolerance o {tol_o}, lse {tol_l}, row "
                             f"{ROW_TOL}, lse abs {LSE_ABS}); bit-equal on a "
                             "second launch")
        self.flash_main()
        Fa.flash_fwd.launches = saved
        say("flash", "max abs error of o, kernel vs plain: "
                     f"{self.max_err['flash_fwd']}")

    def same_bits(self, name, got, again):
        """Two launches of the forward on the same inputs give the same
        bits (o and lse)."""
        if not all(self.torch.equal(a, b) for a, b in zip(got, again)):
            fail("flash", f"{name}: two launches give different bits")

    def flash_main(self):
        """Danube's heads at the main path's shape (S 32,768, window 8,192,
        bf16, strided views of [B, S, H, D] as the model passes them) on
        N(0, 1) inputs, whose scores spread (the model's init gives nearly
        flat ones), against the chunked plain attention and lse in float32;
        then outputs of planted faults, made with the plain version, must
        fail the same check."""
        import math
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import ref_attention_chunked
        S, W, D = PREFILL_S, 8192, 120
        q, k, v = self.attn_inputs(1, 32, 8, S, D, "bfloat16")
        views = [x.transpose(1, 2) for x in (q, k, v)]
        o, lse = Fa.flash_fwd(*views, window=W)
        self.same_bits("main shape", (o, lse),
                       Fa.flash_fwd(*views, window=W))
        o, lse = o.transpose(1, 2), lse.transpose(1, 2)   # [B, S, H, ...]
        kf, vf = k.float(), v.float()
        pos = torch.arange(S, device=self.dev)[None]

        def plain(window=W, scale=1 / math.sqrt(D)):
            qs = q.float() * (scale * math.sqrt(D))
            return (ref_attention_chunked(qs, kf, vf, pos, pos,
                                          window=window),
                    chunked_lse(torch, qs, kf, window, 1 / math.sqrt(D)))

        def zero_rows():
            oz = o.clone()
            oz[:, W:] = 0
            return oz, lse

        def diagonal_shifted():
            # each row also sees the key after its own; the window's left
            # edge stays where it is
            return ref_attention_chunked(q.float(), kf, vf, pos + 1, pos,
                                         window=W + 1), l_ref

        o_ref, l_ref = plain()
        tols = FLASH_TOL["bfloat16"]
        ok, eo, msg = self.attn_close(o, lse, o_ref, l_ref, *tols)
        self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"], eo)
        name = f"danube heads 32/8 D={D} S={S} window={W} bf16 [B,S,H,D] view"
        if not ok:
            fail("flash", f"{name}: {msg}")
        say("flash", f"{name}, N(0,1) inputs, vs the chunked plain version "
                     f"in float32: max abs err {msg}; |o| rms "
                     f"{o_ref.pow(2).mean().sqrt().item():.3g}")
        caught = []
        for fault, make in (
                ("window one key tile wider", lambda: plain(W + 64)),
                ("window one key tile narrower", lambda: plain(W - 64)),
                ("window ignored", lambda: plain(0)),
                ("scale 1/sqrt(128)", lambda: plain(W, 1 / math.sqrt(128))),
                (f"rows past {W:,} zeroed", zero_rows),
                ("diagonal one key later", diagonal_shifted)):
            fo, fl = make()
            passes, _, fmsg = self.attn_close(fo, fl, o_ref, l_ref, *tols)
            if passes:
                fail("flash", f"planted fault passes the check: {fault}: "
                              f"{fmsg}")
            caught.append(f"{fault}: {fmsg}")
        say("flash", "planted faults at that shape, each failing the check: "
                     + "; ".join(caught))

    # ------------------------------------------- 9. flash backward vs plain
    def bwd_inputs(self, B, hq, hkv, S, D, dtype, window):
        """q, k, v, do [B, S, H, D] on the card (N(0, 1), from numpy), and
        the forward kernel's o [B, S, Hq, D] and lse [B, Hq, S] for them."""
        Fa = self.Fa
        q, k, v = self.attn_inputs(B, hq, hkv, S, D, dtype)
        do = self.attn_inputs(B, hq, hq, S, D, dtype, seed=1)[0]
        saved = Fa.flash_fwd.launches
        o, lse = Fa.flash_fwd(*(x.transpose(1, 2) for x in (q, k, v)),
                              window=window)
        Fa.flash_fwd.launches = saved
        return q, k, v, o.transpose(1, 2), lse, do

    def bwd_close(self, got, want, dtype):
        """(ok, (max abs error of dq, of dk/dv), message): the kernels'
        (dq, dk, dv) against the plain backward's in float32, each row to
        ROW_TOL of its max |value| (floored at ROW_FLOOR of the tensor's),
        and in float32 also at the reference's REF_GRAD_TOL."""
        torch = self.torch
        ok, errs, msgs = True, [], []
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            a, r = a.float(), r.float()
            d = (a - r).abs()
            den = r.abs().amax(-1).clamp_min(ROW_FLOOR * r.abs().max())
            row = (d.amax(-1) / den).max().item()
            good = bool(torch.isfinite(a).all()) and row <= ROW_TOL
            if dtype == "float32":
                good &= bool(torch.allclose(a, r, atol=REF_GRAD_TOL,
                                            rtol=REF_GRAD_TOL))
            ok &= good
            errs.append(d.max().item())
            msgs.append(f"{name} {errs[-1]:.3g} (row {row:.3g})")
        return ok, (errs[0], max(errs[1:])), ", ".join(msgs)

    def flash_bwd(self):
        torch, Fa = self.torch, self.Fa
        shapes = [(f"BH={bh} group={g} S={S} D={D} window={w}", 1, bh,
                   bh // g, S, D, w) for bh, g, S, D, w in FLASH_CASES]
        shapes += [(f"training shape B={TRAIN_B} heads 32/8 D=120 "
                    f"S={TRAIN_S} window={w}", TRAIN_B, 32, 8, TRAIN_S, 120,
                    w) for w in BWD_WINDOWS]
        saved = (Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv)
        for name, B, hq, hkv, S, D, w in shapes:
            for dtype in FLASH_TOL:
                q, k, v, o, lse, do = self.bwd_inputs(B, hq, hkv, S, D,
                                                      dtype, w)
                flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                        for x in (q, k, v, o, do)]
                lse3 = lse.reshape(-1, S)
                # the plain version in float32 on the same values
                want = Fa.attention_bwd_ref(*flat[:4], lse3, flat[4],
                                            window=w)
                g3 = Fa.flash_bwd(*flat[:4], lse3, flat[4], window=w)
                again = Fa.flash_bwd(*flat[:4], lse3, flat[4], window=w)
                # strided [B, H, S, D] views of [B, S, H, D]: no copy
                views = [x.transpose(1, 2) for x in (q, k, v, o, do)]
                g4 = Fa.flash_bwd(*views[:4], lse, views[4], window=w)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(g3, again)):
                    fail("flash_bwd", f"{name} {dtype}: two launches give "
                                      "different bits")
                msgs = []
                for layout, g in (("[BH,S,D]", g3),
                                  ("[B,S,H,D] view",
                                   [x.reshape(-1, S, D) for x in g4])):
                    ok, (eq, ekv), msg = self.bwd_close(g, want, dtype)
                    self.max_err["flash_dq"] = max(self.max_err["flash_dq"],
                                                   eq)
                    self.max_err["flash_dkv"] = max(
                        self.max_err["flash_dkv"], ekv)
                    if not ok:
                        fail("flash_bwd", f"{name} {dtype} {layout}: {msg}")
                    msgs.append(f"{layout} {msg}")
                say("flash_bwd", f"{name} {dtype}: max abs err "
                                 f"{'; '.join(msgs)}; bit-equal on a second "
                                 f"launch (row tolerance {ROW_TOL}, floor "
                                 f"{ROW_FLOOR}"
                                 + (f", allclose {REF_GRAD_TOL})"
                                    if dtype == "float32" else ")"))
                del q, k, v, o, lse, do, flat, want, g3, again, g4, views
        self.bwd_faults()
        Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv = saved
        say("flash_bwd", "max abs error, kernel vs plain: dq "
                         f"{self.max_err['flash_dq']}, dk/dv "
                         f"{self.max_err['flash_dkv']}")

    def bwd_faults(self):
        """Outputs of planted faults, made from the plain version at the
        training shape with the window that bites (bf16), must fail the
        check that the kernels pass."""
        import math
        torch, Fa = self.torch, self.Fa
        hq, hkv, S, D, w = 32, 8, TRAIN_S, 120, BWD_WINDOWS[1]
        g = hq // hkv
        q, k, v, o, lse, do = self.bwd_inputs(TRAIN_B, hq, hkv, S, D,
                                              "bfloat16", w)
        fq, fk, fv, fo, fdo = [x.transpose(1, 2).reshape(-1, S, D)
                               .contiguous() for x in (q, k, v, o, do)]
        lse3 = lse.reshape(-1, S)
        del q, k, v, o, do

        def plain(qq=fq, kk=fk, vv=fv, oo=fo, window=w):
            return Fa.attention_bwd_ref(qq, kk, vv, oo, lse3, fdo,
                                        window=window)

        want = plain()

        def no_group_sum():          # each KV row's first query head only
            dq, dk, dv = plain(kk=fk.repeat_interleave(g, 0),
                               vv=fv.repeat_interleave(g, 0))
            return dq, dk[::g], dv[::g]

        def scale_128():             # scores and ds scaled by 1/sqrt(128)
            c = math.sqrt(D / 128)
            dq, dk, dv = plain(qq=fq.float() * c)
            return dq * c, dk, dv

        def dq_without_last_tile():
            # the dq kernel's last visible key tile of each query block
            # (DQ_TILE: TQ query rows a block, TK keys a tile) is the one
            # that ends on the block's diagonal: take its share out of dq
            TQ, TK = Fa.DQ_TILE
            n = S // TQ
            last = {Fa.visible_tiles("dq", i, S, w)[1] * TK - i * TQ
                    for i in range(n)}
            if last != {TQ - TK}:
                fail("flash_bwd", f"last visible key tiles start at {last} "
                                  f"within their query blocks, not "
                                  f"{TQ - TK}")
            qt = fq.float().view(-1, n, TQ, D)
            kt, vt = (x.float().repeat_interleave(g, 0).view(
                -1, n, TQ, D)[:, :, TQ - TK:] for x in (fk, fv))
            dot = fdo.float().view(-1, n, TQ, D)
            delta = (fdo.float() * fo.float()).sum(-1).view(-1, n, TQ, 1)
            s = torch.einsum("btqd,btkd->btqk", qt, kt) / math.sqrt(D)
            # key TQ - TK + kk of the block is visible from row qq when
            # TQ - TK + kk <= qq (the window, w > TQ, does not bite here)
            r = torch.arange(TQ, device=self.dev)
            vis = r[None, :TK] + TQ - TK <= r[:, None]
            p = torch.where(vis, torch.exp(s - lse3.view(-1, n, TQ, 1)),
                            torch.zeros((), device=self.dev))
            dp = torch.einsum("btqd,btkd->btqk", dot, vt)
            ds = p * (dp - delta) / math.sqrt(D)
            share = torch.einsum("btqk,btkd->btqd", ds, kt)
            return want[0] - share.reshape(want[0].shape), want[1], want[2]

        caught = []
        for fault, make in (
                ("dk/dv without the group sum", no_group_sum),
                ("delta = 0", lambda: plain(oo=torch.zeros_like(fo))),
                ("window one key tile wider", lambda: plain(window=w + 64)),
                ("window one key tile narrower",
                 lambda: plain(window=w - 64)),
                ("scale 1/sqrt(128)", scale_128),
                ("dq without its last visible key tile",
                 dq_without_last_tile)):
            passes, _, msg = self.bwd_close(make(), want, "bfloat16")
            if passes:
                fail("flash_bwd", f"planted fault passes the check: {fault}:"
                                  f" {msg}")
            caught.append(f"{fault}: {msg}")
        say("flash_bwd", f"planted faults at B={TRAIN_B} S={S} window={w}, "
                         "each failing the check: " + "; ".join(caught))

    # ------------------------------------------ 10. full-width prefill
    def danube_model(self):
        """h2o-danube-3-4b at full width, bf16 weights drawn on the card from
        seed 0, with the flash kernels on and danube's training policy
        (remat per block, which only acts when gradients are taken)."""
        if self.danube is None:
            from repro_torch.configs import registry
            from repro_torch.launch.steps import make_parallel_config
            from repro_torch.models import build_model
            torch = self.torch
            cfg = registry.get_config("h2o_danube_3_4b")
            t0 = time.time()
            self.danube = build_model(
                cfg, make_parallel_config("h2o_danube_3_4b", "train_4k"),
                use_flash=True, seed=0)
            torch.cuda.synchronize()
            n = sum(p.numel() for p in self.danube.parameters())
            say("prefill", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                           f"{cfg.d_model}, heads {cfg.num_heads}/"
                           f"{cfg.num_kv_heads}, head dim "
                           f"{cfg.resolved_head_dim}, window "
                           f"{cfg.sliding_window}; {n:,} parameters drawn "
                           f"on the card in {time.time() - t0:.1f} s")
        return self.danube

    def prefill(self):
        import numpy as np
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import (project_qkv,
                                                  ref_attention_chunked)
        from repro_torch.models.layers import apply_embed, apply_norm
        model = self.danube_model()
        cfg = model.cfg
        S = PREFILL_S
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, S))).to(self.dev)
        with torch.inference_mode():
            model.apply(tokens[:, :1024])        # warm-up: cuBLAS, caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                # main path starts
            t0 = time.time()
            logits, _ = model.apply(tokens)
            last = logits[:, -1].float()
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = Fa.flash_fwd.launches                # main path ends
            peak = torch.cuda.max_memory_allocated()
            shape_ok = tuple(logits.shape) == (1, S, model.vocab_padded)
            del logits
            if n != cfg.num_layers or not shape_ok or \
                    not torch.isfinite(last).all():
                fail("prefill", f"{n} flash launches for {cfg.num_layers} "
                                f"layers, logits shape ok: {shape_ok}, "
                                "finite: "
                                f"{bool(torch.isfinite(last).all())}")
            self.launches["flash_fwd"] = n
            self.rates["prefill"] = S / secs
            say("prefill", f"1 x {S} tokens: {n} flash launches, "
                           f"{secs:.3f} s, {S / secs:,.0f} tokens/s, peak "
                           f"memory {peak / 2**30:.2f} GiB; card {self.card}")
            # layer 0's attention at full length: kernel vs chunked plain
            blk = model.blocks[0]
            pos = torch.arange(S, device=self.dev)[None]
            h = apply_norm(blk.ln1, apply_embed(model.embed, tokens).to(
                torch.bfloat16), cfg)
            q, k, v = project_qkv(blk.attn, h, cfg, pos)
            saved = Fa.flash_fwd.launches
            o_k = Fa.flash_attention(q, k, v, window=cfg.sliding_window)
            Fa.flash_fwd.launches = saved
            # the plain version in float32 on the same bf16 values
            o_r = ref_attention_chunked(q.float(), k.float(), v.float(), pos,
                                        pos, window=cfg.sliding_window)
            torch.cuda.synchronize()
            err = (o_k.float() - o_r).abs().max().item()
            rerr = row_err(o_k, o_r)
            self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"], err)
            tol = FLASH_TOL["bfloat16"][0]
            if not torch.allclose(o_k.float(), o_r, atol=tol, rtol=tol) or \
                    rerr > ROW_TOL:
                fail("prefill", f"layer 0 attention: kernel vs chunked plain "
                                f"max abs err {err}, row err {rerr}")
            say("prefill", f"layer 0 attention {list(q.shape)}: kernel vs "
                           f"chunked plain max abs err {err:.3g}, row err "
                           f"{rerr:.3g} (tolerance {tol}, row {ROW_TOL}; |o| "
                           f"rms {o_r.pow(2).mean().sqrt().item():.3g})")
            del q, k, v, h, o_k, o_r
            # the whole prefill without the kernel
            model.use_flash = False
            torch.cuda.synchronize()
            t0 = time.time()
            logits, _ = model.apply(tokens)
            last_ref = logits[:, -1].float()
            torch.cuda.synchronize()
            secs_ref = time.time() - t0
            del logits
            model.use_flash = True
        err = (last - last_ref).abs().max().item()
        same = bool(last.argmax(-1).eq(last_ref.argmax(-1)).all())
        echo = bool(last.argmax(-1).eq(tokens[:, -1]).all())
        if not torch.allclose(last, last_ref, atol=MODEL_ATOL,
                              rtol=MODEL_RTOL):
            fail("prefill", f"last-token logits, flash vs plain: max abs err "
                            f"{err}")
        say("prefill", f"without the kernel: {secs_ref:.3f} s "
                       f"({S / secs_ref:,.0f} tokens/s); last-token logits "
                       f"flash vs plain max abs err {err:.4g} (|logit| max "
                       f"{last_ref.abs().max().item():.4g}; tolerance atol "
                       f"{MODEL_ATOL} rtol {MODEL_RTOL}), argmax "
                       f"{'agrees' if same else 'differs'}, argmax is the "
                       f"last input token: {echo}")

    # ---------------------------------------------------- 11. serving
    def serve(self):
        import numpy as np
        torch = self.torch
        from repro_torch.models.attention import cached_attention, project_qkv
        from repro_torch.models.layers import apply_embed, apply_norm
        from repro_torch.config import ServeConfig
        from repro_torch.runtime import Request, ServeEngine
        model = self.danube_model()
        cfg = model.cfg
        eng = ServeEngine(model, ServeConfig(batch=8, max_seq=4096))
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(32, 97))).astype(
                                            np.int32), max_new_tokens=32)
                for i in range(12)]
        for r in reqs:
            eng.submit(r)
        calls = [0]
        decode = eng._decode

        def counted(tokens):
            calls[0] += 1
            return decode(tokens)

        eng._decode = counted
        torch.cuda.synchronize()
        t0 = time.time()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        secs = time.time() - t0
        outs = [len(r.out) for r in reqs]
        if len(done) != 12 or outs != [32] * 12 or not all(
                0 <= t < model.vocab_padded for r in reqs for t in r.out):
            fail("serve", f"{len(done)} of 12 requests done, tokens {outs}")
        n_prompt = sum(len(r.prompt) for r in reqs)
        n_new = sum(outs)
        steps = calls[0] - n_prompt
        say("serve", f"12 requests ({n_prompt} prompt tokens, 8 slots) "
                     f"drained in {secs:.2f} s: {calls[0]} decode_step "
                     f"calls ({calls[0] / secs:.1f}/s), {steps} decode steps "
                     f"({steps / secs:.2f} steps/s), {n_new} new tokens "
                     f"({n_new / secs:.1f} tokens/s)")
        self.rates["serve"] = (calls[0] / secs, n_new / secs)
        del eng
        # decode against prefill at full width
        S = 256
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(
            self.dev)
        with torch.inference_mode():
            full, _ = model.apply(toks)
            cache = model.init_cache(1, S)
            for t in range(S):
                lg, cache = model.decode_step(
                    cache, toks[:, t:t + 1],
                    torch.full((1,), t, dtype=torch.int32, device=self.dev))
        a, b = lg[:, 0].float(), full[:, -1].float()
        err = (a - b).abs().max().item()
        if not torch.isfinite(a).all() or not torch.allclose(
                a, b, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            fail("serve", f"decode vs prefill, last logits: max abs err {err}")
        same = bool(a.argmax() == b.argmax())
        say("serve", f"{S}-token prompt: decode_step token by token vs the "
                     f"flash prefill, last logits max abs err {err:.4g} "
                     f"(atol {MODEL_ATOL} rtol {MODEL_RTOL}); argmax "
                     f"{'agrees' if same else 'differs'}, argmax is the last "
                     f"input token: {bool(a.argmax() == toks[0, -1])}")
        # What attention moves at the last token (the logits above hardly
        # see it at this init): layer 0's attention over the cache that
        # decode_step wrote, against the flash kernel over the prompt.
        blk = model.blocks[0]
        pos = torch.arange(S, device=self.dev)[None]
        with torch.inference_mode():
            h = apply_norm(blk.ln1, apply_embed(model.embed, toks).to(
                torch.bfloat16), cfg)
            q, k, v = project_qkv(blk.attn, h, cfg, pos)
            saved = self.Fa.flash_fwd.launches
            o_pre = self.Fa.flash_attention(q, k, v,
                                            window=cfg.sliding_window)[:, -1:]
            self.Fa.flash_fwd.launches = saved
            o_dec = cached_attention(q[:, -1:], cache[0], pos[:, -1],
                                     window=cfg.sliding_window)
        rerr = row_err(o_dec, o_pre)
        if not torch.isfinite(o_dec).all() or rerr > ROW_TOL:
            fail("serve", f"layer 0 attention at the last token, decode cache "
                          f"vs flash prefill: row err {rerr}")
        say("serve", f"layer 0 attention at token {S - 1}: over decode_step's "
                     f"cache vs the flash kernel, row err {rerr:.3g} "
                     f"(tolerance {ROW_TOL})")

    # -------------------------------------------- 12. full-width training
    def train_batches(self, n: int) -> list:
        """The first ``n`` SyntheticLM batches (seed 0) of danube's train_4k
        shape cut to TRAIN_B sequences, on the card."""
        from repro_torch.data import DataConfig, SyntheticLM
        data = SyntheticLM(DataConfig(self.danube_model().cfg.vocab_size,
                                      TRAIN_S, TRAIN_B, seed=0))
        out = []
        for step in range(n):
            toks, labs = data.batch(step)
            out.append({"tokens": self.torch.from_numpy(toks).to(self.dev),
                        "labels": self.torch.from_numpy(labs).to(self.dev)})
        return out

    def train_config(self):
        from repro_torch.config import LM_SHAPES
        from repro_torch.launch.steps import make_train_config
        spec = next(sp for sp in LM_SHAPES if sp.name == "train_4k")
        return dataclasses.replace(make_train_config("h2o_danube_3_4b",
                                                     spec),
                                   global_batch=TRAIN_B)

    def train(self):
        torch, Fa = self.torch, self.Fa
        from repro_torch.optim import init_opt_state
        from repro_torch.runtime import make_loss_fn, make_train_step
        model = self.danube_model()
        cfg = model.cfg
        tcfg = self.train_config()
        batches = self.train_batches(TRAIN_STEPS + 1)
        params = dict(model.named_parameters())
        # one step's gradients through the flash kernels and the plain path
        loss_fn = make_loss_fn(model, cfg)

        def grads(use_flash):
            model.use_flash = use_flash
            torch.cuda.synchronize()
            t0 = time.time()
            loss = loss_fn(batches[0])
            g = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            return float(loss.detach()), g, time.time() - t0

        lf, gf, tf = grads(True)
        lp, gp, tp = grads(False)
        model.use_flash = True
        rel = {}
        for name, a, b in zip(params, gf, gp):
            a, b = a.float(), b.float()
            rel[name] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            if not torch.isfinite(a).all():
                fail("train", f"non-finite gradient in {name}")
        del gf, gp
        worst = max(rel, key=rel.get)
        by_kind: dict = {}
        for name, r in rel.items():
            kind = name.split(".")[-1] if "blocks" in name else name
            by_kind[kind] = max(by_kind.get(kind, 0.0), r)
        if rel[worst] > GRAD_REL_L2 or abs(lf - lp) > GRAD_LOSS_RTOL * abs(lp):
            fail("train", f"flash vs plain gradients: {worst} rel L2 "
                          f"{rel[worst]}; losses {lf} vs {lp}")
        say("train", f"{cfg.name} at full width, {TRAIN_B} x {TRAIN_S} "
                     f"tokens: step 0's loss {lf:.4f} through the flash "
                     f"kernels ({tf:.2f} s), {lp:.4f} through the plain path"
                     f" ({tp:.2f} s); gradients' relative L2 distance per "
                     f"leaf at most {rel[worst]:.3g} ({worst}; tolerance "
                     f"{GRAD_REL_L2}); by leaf kind: "
                     + ", ".join(f"{k} {v:.3g}" for k, v in by_kind.items()))
        # the main path: make_train_step with AdamW
        opt = init_opt_state(params, tcfg)
        step = make_train_step(model, cfg, tcfg, model.par)
        host = {n: p.detach().cpu() for n, p in params.items()}
        opt, met = step(opt, batches[0])              # warm-up step, lr 0
        loss0, lr0 = float(met["loss"]), float(met["lr"])
        same = [n for n, p in params.items()
                if torch.equal(p.detach().cpu(), host[n])]
        del host
        if len(same) != len(params) or lr0 != 0.0:
            fail("train", f"step 0 (lr {lr0}) changed "
                          f"{len(params) - len(same)} of {len(params)} "
                          "parameters")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Fa.flash_fwd.launches = 0                     # main path starts
        Fa.flash_bwd.launches_dq = Fa.flash_bwd.launches_dkv = 0
        t0 = time.time()
        losses, lrs = [], []
        for b in batches[1:]:
            opt, met = step(opt, b)
            losses.append(float(met["loss"]))
            lrs.append(float(met["lr"]))
        torch.cuda.synchronize()
        secs = time.time() - t0
        n_fwd = Fa.flash_fwd.launches                 # main path ends
        n_dq, n_dkv = Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv
        peak = torch.cuda.max_memory_allocated()
        want = cfg.num_layers * TRAIN_STEPS
        finite = all(x == x and abs(x) != float("inf") for x in losses)
        if (n_fwd, n_dq, n_dkv) != (2 * want, want, want) or not finite:
            fail("train", f"{n_fwd} forward, {n_dq} dq, {n_dkv} dk/dv "
                          f"launches in {TRAIN_STEPS} steps (want "
                          f"{2 * want}, {want}, {want}); losses {losses}")
        self.launches["flash_dq"], self.launches["flash_dkv"] = n_dq, n_dkv
        tokens = TRAIN_STEPS * TRAIN_B * TRAIN_S
        self.rates["train"] = (tokens / secs, 1e3 * secs / TRAIN_STEPS, peak)
        say("train", f"warm-up step: loss {loss0:.4f}, lr 0, all "
                     f"{len(params)} parameters bit-equal to their initial "
                     f"values; {TRAIN_STEPS} steps of make_train_step: "
                     f"losses {[round(x, 4) for x in losses]}, lr "
                     f"{lrs[0]:.3g}..{lrs[-1]:.3g}; {n_fwd} flash forward "
                     f"launches (forward and remat recompute), {n_dq} dq, "
                     f"{n_dkv} dk/dv; {1e3 * secs / TRAIN_STEPS:.1f} ms a "
                     f"step, {tokens / secs:,.0f} tokens/s, peak memory "
                     f"{peak / 2**30:.2f} GiB; card {self.card}")
        del opt, step
        self.train_smoke()

    def train_smoke(self):
        """The smoke-width Trainer on the card, as tests/test_runtime.py
        runs it: the loss falls, a restart replays the straight run, an
        injected failure recovers."""
        import numpy as np
        from repro_torch.config import ParallelConfig, TrainConfig
        from repro_torch.configs import registry
        from repro_torch.models import build_model
        from repro_torch.runtime import SimulatedFailure, Trainer
        cfg = registry.get_config("h2o_danube_3_4b", smoke=True)
        par = ParallelConfig(remat="none", scan_layers=False)
        root = ROOT / "build" / "chip_smoke_ckpt"
        shutil.rmtree(root, ignore_errors=True)

        def trainer(name, steps, every, injector=None):
            tcfg = TrainConfig(global_batch=4, seq_len=32, lr=1e-2,
                               warmup_steps=2, total_steps=steps,
                               ckpt_every=every, ckpt_keep=2,
                               ckpt_dir=str(root / name), ckpt_async=False,
                               seed=1)
            return Trainer(model, cfg, tcfg, par, failure_injector=injector)

        model = build_model(cfg, par, seed=0)
        rep = trainer("loss", 30, 100).run()
        first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
        if not last < first - 0.2:
            fail("train", f"smoke Trainer: loss {first} -> {last}")
        straight = trainer("a", 8, 4).run()
        trainer("b", 8, 4).run(steps=5)
        resumed = trainer("b", 8, 4).run(steps=8)
        a, b = resumed.losses[-1], straight.losses[-1]
        if abs(a - b) > 1e-4 * abs(b):
            fail("train", f"smoke Trainer: restart {a} vs straight {b}")
        exact = resumed.losses == straight.losses[5:]
        crashed = []

        def injector(s):
            if s == 5 and not crashed:
                crashed.append(s)
                raise SimulatedFailure("node lost")

        rec = trainer("f", 8, 2, injector).run()
        if rec.restarts != 1 or not np.isfinite(rec.final_loss):
            fail("train", f"smoke Trainer: {rec.restarts} restarts, final "
                          f"loss {rec.final_loss}")
        shutil.rmtree(root, ignore_errors=True)
        say("train", f"smoke Trainer on the card: loss {first:.3f} -> "
                     f"{last:.3f} over 30 steps; restart from step 4 replays"
                     f" steps 5-7 {'exactly' if exact else 'within rel 1e-4'}"
                     f" (last loss {a!r} vs {b!r}); one injected failure at "
                     f"step 5 recovered, final loss {rec.final_loss:.4f}")

    # ---------------------------------------- 13. SSD kernel vs plain
    def ssd_case(self, B, S, H, P, N, bc_dtype, seed=0, x_bf16=False,
                 a_scale=0.1):
        """x [B, S, H, P] N(0, 1) float32, a = -|N(0, 1)| * a_scale and B/C
        [B, S, N] N(0, 1) in ``bc_dtype``, drawn on the card from a
        torch.Generator seeded with ``seed``: the reference's test inputs
        (tests/test_kernels.py:86-89)."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)

        def normal(*shape):
            return torch.randn(shape, generator=g, device=self.dev)

        x = normal(B, S, H, P)
        if x_bf16:
            x = x.bfloat16().float()
        a = -normal(B, S, H).abs() * a_scale
        dt = getattr(torch, bc_dtype)
        return x, a, normal(B, S, N).to(dt), normal(B, S, N).to(dt)

    def plain_ssd(self, x, a, Bm, Cm, chunk, fault=None):
        """The plain version of ops.ssd on the card: S padded, rows mapped
        to [B*H, S, P], ``Sd.ssd_chunked_ref`` (or :func:`faulty_ssd` with
        a planted ``fault``), mapped back.  Returns (y [B, S, H, P], final
        state [B, H, P, N])."""
        import torch.nn.functional as F
        B, S, H, P = x.shape
        pad = (-S) % chunk
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            a = F.pad(a, (0, 0, 0, pad))
            Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        xf = x.transpose(1, 2).reshape(B * H, S + pad, P)
        af = a.transpose(1, 2).reshape(B * H, S + pad)
        if fault is None:
            y, fs = self.Sd.ssd_chunked_ref(xf, af, Bm, Cm, chunk=chunk,
                                            n_heads=H)
        else:
            y, fs = faulty_ssd(self.torch, xf, af, Bm, Cm, chunk, H, fault)
        return (y.reshape(B, H, S + pad, P).transpose(1, 2)[:, :S],
                fs.reshape(B, H, -1, P).transpose(-1, -2))

    def ssd_close(self, got, want):
        """(ok, max abs error, message): y and the final state against the
        plain version's at the reference's SSD_TOL (atol and rtol)."""
        torch = self.torch
        ok, errs = True, []
        for name, g, w in zip(("y", "state"), got, want):
            ok &= bool(torch.isfinite(g).all() and torch.allclose(
                g, w, atol=SSD_TOL, rtol=SSD_TOL))
            errs.append((g - w).abs().max().item())
        ymax = want[0].abs().max().item()
        return ok, max(errs), (f"y {errs[0]:.3g} (|y| max {ymax:.3g}, "
                               f"relative {errs[0] / max(ymax, 1e-30):.3g}),"
                               f" state {errs[1]:.3g}")

    def ssd_check(self, name, x, a, Bm, Cm, chunk, layouts=True,
                  phase="ssd"):
        """The kernel through ops.ssd (strided [B, H, S, P] views) and, with
        ``layouts`` (S a multiple of the chunk), through ssd_chunked on
        contiguous [B, H, S, P] copies, against the plain version; a second
        launch must give the same bits."""
        torch, Sd = self.torch, self.Sd
        want = self.plain_ssd(x, a, Bm, Cm, chunk)
        got = Sd.ssd(x, a, Bm, Cm, chunk=chunk)
        again = Sd.ssd(x, a, Bm, Cm, chunk=chunk)
        runs = [("[B,S,H,P] view", got)]
        if layouts:
            y4, fs4 = Sd.ssd_chunked(
                x.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous(),
                Bm, Cm, chunk=chunk, n_heads=x.shape[2])
            runs.append(("[B,H,S,P] copy", (y4.transpose(1, 2),
                                            fs4.transpose(-1, -2))))
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(phase, f"{name}: two launches give different bits")
        msgs = []
        for layout, out in runs:
            ok, err, msg = self.ssd_close(out, want)
            self.max_err["ssd"] = max(self.max_err["ssd"], err)
            if not ok:
                fail(phase, f"{name} {layout}: {msg}")
            msgs.append(f"{layout} {msg}")
        say(phase, f"{name}: max abs err {'; '.join(msgs)}; bit-equal on a "
                   f"second launch (tolerance {SSD_TOL})")
        return want

    def ssd(self):
        torch, Sd = self.torch, self.Sd
        saved = Sd.ssd_chunked.launches
        for B, S, H, P, N, Q, x_bf16 in SSD_CASES:
            for bc in ("float32", "bfloat16"):
                x, a, Bm, Cm = self.ssd_case(B, S, H, P, N, bc, x_bf16=x_bf16)
                self.ssd_check(f"B={B} S={S} H={H} P={P} N={N} chunk={Q} "
                               f"B/C {bc}", x, a, Bm, Cm, Q,
                               layouts=S % Q == 0)
        # the main path's shape
        B, S, H, P, N, Q = SSD_MAIN
        x, a, Bm, Cm = self.ssd_case(B, S, H, P, N, "bfloat16")
        self.ssd_check(f"main shape B={B} H={H} S={S} P={P} N={N} chunk={Q}"
                       f", B/C bf16, N(0,1) inputs", x, a, Bm, Cm, Q,
                       layouts=False)
        del x, a, Bm, Cm
        # layer 0's own inputs from a full-width prefill
        x, a, Bm, Cm = self.mamba_layer0_inputs()
        self.ssd_check(f"layer 0 of a {x.shape[0]} x {x.shape[1]} mamba2 "
                       f"prefill (a in [{a.min().item():.3g}, "
                       f"{a.max().item():.3g}], B/C {Bm.dtype})", x, a, Bm,
                       Cm, Q, layouts=False)
        del x, a, Bm, Cm
        self.ssd_faults()
        Sd.ssd_chunked.launches = saved
        say("ssd", f"max abs error, kernel vs plain: {self.max_err['ssd']}")

    def ssd_faults(self):
        """Outputs of planted faults, made with a copy of the plain chunk
        walk, must fail the check the kernel passes (B = H = 4 so that the
        row-index fault reads rows that exist)."""
        B, S, H, P, N, Q = SSD_FAULT_SHAPE
        x, a, Bm, Cm = self.ssd_case(B, S, H, P, N, "bfloat16", seed=3)
        want = self.plain_ssd(x, a, Bm, Cm, Q)
        caught = []
        for fault in SSD_FAULTS:
            passes, _, msg = self.ssd_close(
                self.plain_ssd(x, a, Bm, Cm, Q, fault=fault), want)
            if passes:
                fail("ssd", f"planted fault passes the check: {fault}: {msg}")
            caught.append(f"{fault}: {msg}")
        say("ssd", f"planted faults at B={B} H={H} S={S} P={P} N={N} chunk="
                   f"{Q}, each failing the check: " + "; ".join(caught))

    # --------------------------------------------- 14. mamba2 at full width
    def mamba_model(self):
        """mamba2-130m at full width, bf16 weights drawn on the card from
        seed 0, with the SSD kernel on."""
        if self.mamba_lm is None:
            from repro_torch.config import param_count
            from repro_torch.configs import registry
            from repro_torch.models import build_model
            cfg = registry.get_config("mamba2_130m")
            t0 = time.time()
            self.mamba_lm = build_model(cfg, use_ssd_kernel=True, seed=0)
            self.torch.cuda.synchronize()
            n = sum(p.numel() for p in self.mamba_lm.parameters())
            pad = (self.mamba_lm.vocab_padded - cfg.vocab_size) * cfg.d_model
            if n - pad != param_count(cfg):
                fail("mamba", f"{n:,} parameters built, {pad:,} of them "
                              f"vocab padding; param_count "
                              f"{param_count(cfg):,}")
            say("mamba", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                         f"{cfg.d_model}, state {cfg.ssm.d_state}, head dim "
                         f"{cfg.ssm.head_dim}, chunk {cfg.ssm.chunk_size}; "
                         f"{n:,} parameters drawn on the card in "
                         f"{time.time() - t0:.1f} s: param_count "
                         f"{param_count(cfg):,} plus {pad:,} of the "
                         f"embedding's vocab padding ({cfg.vocab_size} -> "
                         f"{self.mamba_lm.vocab_padded})")
        return self.mamba_lm

    def mamba_tokens(self):
        import numpy as np
        cfg = self.mamba_model().cfg
        return self.torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (MAMBA_B, PREFILL_S))).to(self.dev)

    def mamba_layer0_inputs(self, model=None, tokens=None):
        """Layer 0's scan inputs (xs, a, Bm, Cm) as the model's prefill
        (mamba2's of MAMBA_B x 32,768 tokens unless given) hands them to
        ops.ssd, captured there (the prefill stops at that call)."""
        import repro_torch.models.ssm as ssm_mod
        torch = self.torch
        model = model or self.mamba_model()
        tokens = self.mamba_tokens() if tokens is None else tokens
        held = {}

        class Captured(Exception):
            pass

        def capture(*args, **kw):
            held["args"] = args
            raise Captured

        real, ssm_mod.ssd = ssm_mod.ssd, capture
        try:
            with torch.inference_mode():
                model.apply(tokens)
        except Captured:
            pass
        finally:
            ssm_mod.ssd = real
        return held["args"]

    def logit_spread(self, what, got, want, tokens):
        """bf16 logits of two paths ([..., vocab], ``tokens`` [...] each
        row's input token).  (passes, message): the input token's logit
        within ECHO_RTOL of itself, the rest of each row within
        BF16_REL_L2 (relative L2), every argmax equal; the message also
        gives the largest error over the row's median |logit| and the
        counts beyond the model tolerances."""
        torch = self.torch
        got, want = got.float(), want.float()
        col = tokens.long().unsqueeze(-1)
        we = want.gather(-1, col)
        echo = ((got.gather(-1, col) - we).abs() /
                we.abs().clamp_min(1e-30)).max().item()
        rest = torch.ones_like(want, dtype=torch.bool).scatter_(-1, col, False)
        d = (got - want).where(rest, 0)
        w = want.where(rest, 0)
        rel = (d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()
        med = (d.abs().amax(-1) / w.abs().median(-1).values.clamp_min(1e-30)
               ).max().item()
        err = (got - want).abs()
        out = [int((err > a + r * want.abs()).sum())
               for a, r in ((MODEL_ATOL, MODEL_RTOL),
                            (DECODE_ATOL, DECODE_RTOL))]
        same = bool(got.argmax(-1).eq(want.argmax(-1)).all())
        ok = bool(torch.isfinite(got).all()) and same and \
            echo <= ECHO_RTOL and rel <= BF16_REL_L2
        return ok, (
            f"{what} in bf16: input token's logit rel err {echo:.3g} "
            f"(tolerance {ECHO_RTOL}); other logits rel L2 {rel:.3g} "
            f"(tolerance {BF16_REL_L2}), max abs err {med:.3g} x the row's "
            f"median |logit|; argmax agrees: {same}; max abs err "
            f"{err.max().item():.4g} (|logit| max "
            f"{want.abs().max().item():.4g}); {out[0]} of {err.numel()} "
            f"outside atol {MODEL_ATOL} rtol {MODEL_RTOL}, {out[1]} outside "
            f"atol {DECODE_ATOL} rtol {DECODE_RTOL}; argmax is the input "
            f"token: {bool(want.argmax(-1).eq(tokens).all())}")

    def hold_logits(self, *args, phase="mamba"):
        ok, msg = self.logit_spread(*args)
        say(phase, msg)
        if not ok:
            fail(phase, msg)

    @contextlib.contextmanager
    def planted(self, fault):
        """Within: layer FAULT_LAYER's scan on the kernel route is the plain
        chunk walk with a planted ``fault`` (one prefill at a time)."""
        import repro_torch.models.ssm as ssm_mod
        scan, seen = ssm_mod.ssd, [0]

        def faulty(x, a, Bm, Cm, *, chunk):
            seen[0] += 1
            if seen[0] - 1 == FAULT_LAYER:
                return self.plain_ssd(x, a, Bm, Cm, chunk, fault=fault)
            return scan(x, a, Bm, Cm, chunk=chunk)

        ssm_mod.ssd = faulty
        try:
            yield
        finally:
            ssm_mod.ssd = scan

    def mamba_float32(self, fn):
        """``fn(model)`` on the full-width model in float32 (weights
        widened, exactly restored after)."""
        with as_float32(self.mamba_model()) as model:
            return fn(model)

    def decode_and_prefill(self, model, toks, positions=None):
        """Logits of ``toks`` [1, T] decoded token by token
        (decode_step, ssm_decode) and prefilled through the kernel (at
        ``positions``, the model's default when None), float32 [1, T,
        vocab] each."""
        torch = self.torch
        T = toks.shape[1]
        with torch.inference_mode():
            full, _ = model.apply(toks, positions=positions)
            cache = model.init_cache(1, T)
            outs = []
            for t in range(T):
                lg, cache = model.decode_step(
                    cache, toks[:, t:t + 1],
                    torch.full((1,), t, dtype=torch.int32, device=self.dev))
                outs.append(lg[:, 0])
        return torch.stack(outs, 1).float(), full.float()

    def mamba(self):
        import numpy as np
        torch, Sd = self.torch, self.Sd
        from repro_torch.config import ServeConfig
        from repro_torch.runtime import Request, ServeEngine
        model = self.mamba_model()
        cfg = model.cfg
        tokens = self.mamba_tokens()
        B, S = tokens.shape

        def last_logits(use_kernel, toks):
            model.use_ssd_kernel = use_kernel
            with torch.inference_mode():
                logits, _ = model.apply(toks)
                last = logits[:, -1].float()
            model.use_ssd_kernel = True
            return last, tuple(logits.shape)

        with torch.inference_mode():
            model.apply(tokens[:1, :1024])          # warm-up: cuBLAS, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Sd.ssd_chunked.launches = 0                 # main path starts
        t0 = time.time()
        last, shape = last_logits(True, tokens)
        torch.cuda.synchronize()
        secs = time.time() - t0
        n = Sd.ssd_chunked.launches                 # main path ends
        peak = torch.cuda.max_memory_allocated()
        if n != cfg.num_layers or shape != (B, S, model.vocab_padded) or \
                not torch.isfinite(last).all():
            fail("mamba", f"{n} SSD launches for {cfg.num_layers} layers, "
                          f"logits {shape}, finite: "
                          f"{bool(torch.isfinite(last).all())}")
        self.launches["ssd"] = n
        self.rates["mamba_prefill"] = (B * S / secs, peak)
        say("mamba", f"prefill {B} x {S} tokens: {n} SSD launches, "
                     f"{secs:.3f} s, {B * S / secs:,.0f} tokens/s, peak "
                     f"memory {peak / 2**30:.2f} GiB; card {self.card}")
        # the whole prefill on the plain path
        torch.cuda.synchronize()
        t0 = time.time()
        last_ref, _ = last_logits(False, tokens)
        torch.cuda.synchronize()
        secs_ref = time.time() - t0
        say("mamba", f"plain path: {secs_ref:.3f} s "
                     f"({B * S / secs_ref:,.0f} tokens/s)")
        self.hold_logits(f"last-token logits of {B} rows, kernel vs plain",
                         last, last_ref, tokens[:, -1])
        # a planted fault's bf16 reading (held in float32 below)
        saved = Sd.ssd_chunked.launches
        fault = "diagonal of L dropped"
        with self.planted(fault):
            bad, _ = last_logits(True, tokens)
        say("mamba", "reading only: " + self.logit_spread(
            f"control ({fault} in layer {FAULT_LAYER}) vs plain", bad,
            last_ref, tokens[:, -1])[1])
        # decode against prefill on a fresh 1-slot cache
        T = 256
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, T))).to(
            self.dev)
        dec, full = self.decode_and_prefill(model, toks)
        self.hold_logits(f"{T}-token prompt, all logits, decode_step "
                         "(ssm_decode) vs the kernel's prefill", dec[0],
                         full[0], toks[0])

        # The same two comparisons in float32, where no bf16 rounding
        # amplifies the paths' float32 differences through 24 layers: held
        # to the CPU tests' float32 model tolerance, which the planted
        # fault must fail.
        def in_float32(m32):
            a, _ = last_logits(True, tokens[:1])
            b, _ = last_logits(False, tokens[:1])
            with self.planted(fault):
                c, _ = last_logits(True, tokens[:1])
            return (a, b), self.decode_and_prefill(m32, toks), (c, b)

        pairs = list(zip((f"last-token logits of 1 x {S}, kernel vs plain",
                          f"{T}-token prompt, all logits, decode vs prefill",
                          f"control ({fault} in layer {FAULT_LAYER}) vs "
                          "plain"), self.mamba_float32(in_float32)))
        Sd.ssd_chunked.launches = saved
        for k, (what, (a, b)) in enumerate(pairs):
            err = (a - b).abs().max().item()
            ok = bool(torch.isfinite(a).all()) and torch.allclose(
                a, b, atol=F32_ATOL, rtol=F32_RTOL)
            if ok == (k == 2):
                fail("mamba", f"{what} in float32: max abs err {err}")
            say("mamba", f"{what} in float32: max abs err {err:.3g} (|logit|"
                         f" max {b.abs().max().item():.4g}; atol {F32_ATOL} "
                         f"rtol {F32_RTOL}){'; fails, as it must' * (k == 2)}")
        # serving: danube's serving cell
        eng = ServeEngine(model, ServeConfig(batch=8, max_seq=4096))
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(32, 97))).astype(
                                            np.int32), max_new_tokens=32)
                for i in range(12)]
        for r in reqs:
            eng.submit(r)
        calls, fed, last = [0], [], [None]
        decode = eng._decode

        def counted(tokens):
            calls[0] += 1
            fed.append(tokens[REPLAY_SLOT, 0])
            last[0] = decode(tokens)
            return last[0]

        eng._decode = counted
        torch.cuda.synchronize()
        t0 = time.time()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        secs = time.time() - t0
        outs = [len(r.out) for r in reqs]
        finite = all(bool(torch.isfinite(c.state).all()) for c in eng.cache)
        if len(done) != 12 or outs != [32] * 12 or not finite or not all(
                0 <= t < model.vocab_padded for r in reqs for t in r.out):
            fail("mamba", f"serving: {len(done)} of 12 requests done, tokens "
                          f"{outs}, states finite: {finite}")
        n_prompt = sum(len(r.prompt) for r in reqs)
        n_new = sum(outs)
        steps = calls[0] - n_prompt
        self.rates["mamba_serve"] = (calls[0] / secs, steps / secs,
                                     n_new / secs)
        say("mamba", f"serving 12 requests ({n_prompt} prompt tokens, 8 "
                     f"slots, max_seq 4096) drained in {secs:.2f} s: "
                     f"{calls[0]} decode_step calls ({calls[0] / secs:.1f}/s)"
                     f", {steps} decode steps ({steps / secs:.2f} steps/s), "
                     f"{n_new} new tokens ({n_new / secs:.1f} tokens/s)")
        self.serve_replay(model, eng, fed, last[0][REPLAY_SLOT])

    def serve_replay(self, model, eng, fed, logits):
        """Slot REPLAY_SLOT of the served run (a reused slot, stepped on
        token 0 while other slots took prompt tokens) against a 1-slot
        decode of the tokens that slot was fed, call by call: its last
        logits held as the other bf16 logits are, and every layer's state
        and conv window to BF16_REL_L2 (relative L2)."""
        torch = self.torch
        cache = model.init_cache(1, eng.scfg.max_seq)
        zero = torch.zeros(1, dtype=torch.int32, device=self.dev)
        t0 = time.time()
        with torch.inference_mode():
            for t in fed:
                lg, cache = model.decode_step(cache, torch.full(
                    (1, 1), int(t), dtype=torch.int32, device=self.dev), zero)
        torch.cuda.synchronize()
        secs = time.time() - t0
        rel = max((u[REPLAY_SLOT].float() - v[0].float()).norm().item() /
                  max(v[0].float().norm().item(), 1e-30)
                  for c, r in zip(eng.cache, cache)
                  for u, v in ((c.state, r.state), (c.conv, r.conv)))
        self.hold_logits(f"serving slot {REPLAY_SLOT}'s last logits vs a "
                         f"1-slot replay of its {len(fed)} tokens",
                         logits[-1], lg[0, -1], torch.tensor(
                             int(fed[-1]), device=self.dev))
        say("mamba", f"serving slot {REPLAY_SLOT} vs the 1-slot replay "
                     f"({secs:.1f} s): every layer's state and conv window "
                     f"within rel L2 {rel:.3g} (tolerance {BF16_REL_L2})")
        if not rel <= BF16_REL_L2:
            fail("mamba", f"serving slot {REPLAY_SLOT}'s caches vs the "
                          f"1-slot replay: rel L2 {rel}")

    # ------------------------------------------- 15. MoE: granite at width
    def granite_model(self):
        """granite-moe-1b-a400m at full width, bf16 weights drawn on the
        card from seed 0, with the flash kernel on."""
        if self.granite is None:
            from repro_torch.config import param_count
            from repro_torch.configs import registry
            from repro_torch.models import build_model
            cfg = registry.get_config("granite_moe_1b_a400m")
            t0 = time.time()
            self.granite = build_model(cfg, use_flash=True, seed=0)
            self.torch.cuda.synchronize()
            n = sum(p.numel() for p in self.granite.parameters())
            pad = (self.granite.vocab_padded - cfg.vocab_size) * cfg.d_model
            if n - pad != param_count(cfg) or \
                    param_count(cfg) != GRANITE_PARAMS:
                fail("moe", f"{n:,} parameters built, {pad:,} of them vocab "
                            f"padding; param_count {param_count(cfg):,}")
            m = cfg.moe
            say("moe", f"{cfg.name}: {cfg.num_layers} layers, d_model "
                       f"{cfg.d_model}, heads {cfg.num_heads}/"
                       f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, "
                       f"{m.num_experts} experts top-{m.experts_per_token} "
                       f"of d_ff {m.d_ff_expert}, capacity factor "
                       f"{m.capacity_factor}; {n:,} parameters drawn on the "
                       f"card in {time.time() - t0:.1f} s: param_count "
                       f"{param_count(cfg):,} plus {pad:,} of vocab padding "
                       f"({cfg.vocab_size} -> {self.granite.vocab_padded})")
        return self.granite

    def family_tokens(self, cfg, B, S, seed=0):
        import numpy as np
        return self.torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, S))).to(self.dev)

    def moe(self):
        import repro_torch.models.moe as moe_mod
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import (attention_block,
                                                  project_qkv,
                                                  ref_attention_chunked)
        from repro_torch.models.layers import apply_embed, apply_norm
        model = self.granite_model()
        cfg = model.cfg
        B, S, L = MOE_B, PREFILL_S, cfg.num_layers
        tokens = self.family_tokens(cfg, B, S)
        k = cfg.moe.experts_per_token
        with torch.inference_mode():
            model.apply(tokens[:1, :1024])          # warm-up: cuBLAS, caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with moe_drop_counter(moe_mod) as drops:
                Fa.flash_fwd.launches = 0            # main path starts
                t0 = time.time()
                logits, aux = model.apply(tokens)
                last = logits[:, -1].float()
                torch.cuda.synchronize()
                secs = time.time() - t0
                n = Fa.flash_fwd.launches            # main path ends
            peak = torch.cuda.max_memory_allocated()
            shape_ok = tuple(logits.shape) == (B, S, model.vocab_padded)
            del logits
            per = per_layer(torch, drops, L)
            if n != L or not shape_ok or not torch.isfinite(last).all() or \
                    not torch.isfinite(aux):
                fail("moe", f"{n} flash launches for {L} layers, logits shape "
                            f"ok: {shape_ok}, finite: "
                            f"{bool(torch.isfinite(last).all())}, aux "
                            f"{float(aux)}")
            self.rates["granite_prefill"] = (B * S / secs, peak)
            say("moe", f"prefill {B} x {S} tokens: {n} flash launches, "
                       f"{len(drops) // L} dispatch chunks a layer, "
                       f"{secs:.3f} s, {B * S / secs:,.0f} tokens/s, peak "
                       f"memory {peak / 2**30:.2f} GiB, aux loss "
                       f"{float(aux):.6g}; card {self.card}")
            say("moe", f"assignments dropped at capacity, per layer (of "
                       f"{B * S * k:,} a layer): {per}; in all {sum(per):,} "
                       f"({100 * sum(per) / (B * S * k * L):.4f} %)")
            # layer 0's attention at full length: kernel vs chunked plain
            blk = model.blocks[0]
            pos = torch.arange(S, device=self.dev)[None].expand(B, S)
            h = apply_norm(blk.ln1, apply_embed(model.embed, tokens).to(
                torch.bfloat16), cfg)
            q, kk, v = project_qkv(blk.attn, h, cfg, pos)
            saved = Fa.flash_fwd.launches
            o_k = Fa.flash_attention(q, kk, v)
            Fa.flash_fwd.launches = saved
            o_r = ref_attention_chunked(q.float(), kk.float(), v.float(),
                                        pos, pos)
            torch.cuda.synchronize()
            err = (o_k.float() - o_r).abs().max().item()
            rerr = row_err(o_k, o_r)
            self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"], err)
            tol = FLASH_TOL["bfloat16"][0]
            if not torch.allclose(o_k.float(), o_r, atol=tol, rtol=tol) or \
                    rerr > ROW_TOL:
                fail("moe", f"layer 0 attention: kernel vs chunked plain max "
                            f"abs err {err}, row err {rerr}")
            say("moe", f"layer 0 attention {list(q.shape)}: kernel vs chunked"
                       f" plain max abs err {err:.3g}, row err {rerr:.3g} "
                       f"(tolerance {tol}, row {ROW_TOL})")
            # the MoE combine twice on layer 0's own input (first row),
            # bit-equal: no float atomics in the dispatch
            x1 = apply_embed(model.embed, tokens[:1]).to(torch.bfloat16)
            x1 = x1 + attention_block(blk.attn, apply_norm(blk.ln1, x1, cfg),
                                      cfg, pos[:1], use_flash=True)
            Fa.flash_fwd.launches = saved
            h2 = apply_norm(blk.ln2, x1, cfg)
            y1, a1 = moe_mod.moe_block(blk.moe, h2, cfg)
            y2, a2 = moe_mod.moe_block(blk.moe, h2, cfg)
            torch.cuda.synchronize()
            if not (torch.equal(y1, y2) and torch.equal(a1, a2)):
                fail("moe", "the MoE combine run twice on the same input "
                            "differs")
            say("moe", f"layer 0's MoE on its own input (1 x {S}, "
                       f"{S // min(moe_mod.DISPATCH_CHUNK, S)} chunks) run "
                       "twice: outputs and aux bit-equal")
            del q, kk, v, h, o_k, o_r, x1, h2, y1, y2
            # the first row's prefill without the kernel: its 4 dispatch
            # chunks hold the same tokens as in the batch of 8, so its
            # routing and capacities are the same
            model.use_flash = False
            torch.cuda.synchronize()
            t0 = time.time()
            logits, _ = model.apply(tokens[:1])
            last_ref = logits[:, -1].float()
            torch.cuda.synchronize()
            secs_ref = time.time() - t0
            del logits
            model.use_flash = True
        last = last[:1]
        err = (last - last_ref).abs().max().item()
        same = bool(last.argmax(-1).eq(last_ref.argmax(-1)).all())
        if not torch.allclose(last, last_ref, atol=MODEL_ATOL,
                              rtol=MODEL_RTOL):
            fail("moe", f"last-token logits, flash vs plain: max abs err "
                        f"{err}")
        say("moe", f"row 0 without the kernel: {secs_ref:.3f} s "
                   f"({S / secs_ref:,.0f} tokens/s); its last-token logits "
                   f"flash vs plain max abs err {err:.4g} (|logit| max "
                   f"{last_ref.abs().max().item():.4g}; atol {MODEL_ATOL} "
                   f"rtol {MODEL_RTOL}), argmax agrees: {same}, argmax is "
                   f"the last input token: "
                   f"{bool(last.argmax(-1).eq(tokens[:1, -1]).all())}")
        self.decode_against_prefill("moe", model)
        self.family_serve("moe", model)

    def decode_against_prefill(self, phase, model, positions=None,
                               atol=MODEL_ATOL, rtol=MODEL_RTOL,
                               every=False):
        """A DECODE_T-token prompt decoded token by token (1 slot: k
        distinct experts, C_loc 1, nothing drops) against its prefill
        through the kernels (at ``positions``), every position's logits;
        for MoE models compared when the prefill's MoE layers dropped
        nothing (the count is reported either way).  Every position's
        argmax must agree and its logits' relative L2 distance stay within
        BF16_REL_L2 (HYBRID_DECODE_REL_L2 for the hybrid); the last
        position's logits also within ``atol`` / ``rtol`` (the model
        tolerance by default), as danube's serve phase holds them, or with
        ``every`` every position's (the counts outside them at every
        position are reported: bf16 roundings put a few near-zero logits
        past atol 0.15 at full width)."""
        import repro_torch.models.moe as moe_mod
        torch = self.torch
        cfg = model.cfg
        toks = self.family_tokens(cfg, 1, DECODE_T, seed=1)
        n_moe = sum("moe" in b._modules for b in model.blocks)
        t0 = time.time()
        with moe_drop_counter(moe_mod) as drops:
            dec, full = self.decode_and_prefill(model, toks, positions)
        secs = time.time() - t0
        if n_moe:
            pre = per_layer(torch, drops[:n_moe], n_moe)
            dec_drops = int(torch.stack(drops[n_moe:]).sum())
            say(phase, f"{DECODE_T}-token prompt: the prefill's MoE layers "
                       f"drop {sum(pre)} assignments ({pre}), the 1-slot "
                       f"decode steps {dec_drops}")
            if dec_drops:
                fail(phase, f"a 1-slot decode dropped {dec_drops} "
                            "assignments")
            if sum(pre):
                say(phase, "decode vs prefill not compared: the prefill "
                           "dropped assignments")
                return
        what = (f"{DECODE_T}-token prompt ({secs:.1f} s), all logits, "
                "decode_step vs the kernels' prefill")
        err = (dec - full).abs()
        out = int((err > atol + rtol * full.abs()).sum())
        last_ok = torch.allclose(dec[:, -1], full[:, -1], atol=atol,
                                 rtol=rtol)
        same = bool(dec.argmax(-1).eq(full.argmax(-1)).all())
        rel = ((dec - full).norm(dim=-1) / full.norm(dim=-1).clamp_min(
            1e-30)).max().item()
        hybrid = cfg.family == "hybrid"
        rel_tol = HYBRID_DECODE_REL_L2 if hybrid else BF16_REL_L2
        held = "every position" if every else "the last position"
        say(phase, f"{what}: max abs err {err.max().item():.4g} (|logit| max "
                   f"{full.abs().max().item():.4g}; {out} of {err.numel()} "
                   f"outside atol {atol} rtol {rtol}, held at {held}; the "
                   f"last position's within: {last_ok}); largest row rel L2 "
                   f"{rel:.3g} (tolerance {rel_tol}); argmax agrees at every "
                   f"position: {same}")
        held_ok = out == 0 if every else (hybrid or last_ok)
        ok = bool(torch.isfinite(dec).all()) and rel <= rel_tol and same \
            and held_ok
        if not ok:
            fail(phase, f"{what}: row rel L2 {rel}, argmax agrees: {same}, "
                        f"within atol {atol} rtol {rtol} at {held}: "
                        f"{held_ok}")

    def family_serve(self, phase, model, n_req=12, new=32):
        """``n_req`` requests (16-48 prompt tokens, ``new`` new tokens
        each) drained through ServeEngine (8 slots, 4,096 positions).  The
        prompts are half as long as danube's and mamba2's (32-96): prompt
        tokens are prefilled one decode call each, and granite's calls are
        host-bound at ~15 a second."""
        import numpy as np
        torch = self.torch
        from repro_torch.config import ServeConfig
        from repro_torch.runtime import Request, ServeEngine
        cfg = model.cfg
        eng = ServeEngine(model, ServeConfig(batch=8, max_seq=4096))
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(16, 49))).astype(
                                            np.int32), max_new_tokens=new)
                for i in range(n_req)]
        for r in reqs:
            eng.submit(r)
        calls = [0]
        decode = eng._decode

        def counted(tokens):
            calls[0] += 1
            return decode(tokens)

        eng._decode = counted
        torch.cuda.synchronize()
        t0 = time.time()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        secs = time.time() - t0
        outs = [len(r.out) for r in reqs]
        if len(done) != n_req or outs != [new] * n_req or not all(
                0 <= t < model.vocab_padded for r in reqs for t in r.out):
            fail(phase, f"serving: {len(done)} of {n_req} requests done, "
                        f"tokens {outs}")
        n_prompt = sum(len(r.prompt) for r in reqs)
        n_new = sum(outs)
        steps = calls[0] - n_prompt
        self.rates[f"{phase}_serve"] = (calls[0] / secs, n_new / secs)
        say(phase, f"serving {n_req} requests ({n_prompt} prompt tokens, 8 "
                   f"slots, max_seq 4096) drained in {secs:.2f} s: {calls[0]} "
                   f"decode_step calls ({calls[0] / secs:.1f}/s), {steps} "
                   f"decode steps ({steps / secs:.2f} steps/s), {n_new} new "
                   f"tokens ({n_new / secs:.1f} tokens/s)")

    # ---------------------------------------- 16. hybrid: jamba, one period
    def jamba_model(self):
        """jamba-v0.1-52b's first period (8 layers: 7 SSM, 1 attention, MoE
        on the odd ones) at full width, bf16 weights drawn on the card from
        seed 0, with the flash and SSD kernels on."""
        if self.jamba_lm is None:
            from repro_torch.config import param_count
            from repro_torch.configs import registry
            from repro_torch.models import build_model
            cfg = dataclasses.replace(registry.get_config("jamba_v0_1_52b"),
                                      num_layers=JAMBA_LAYERS)
            t0 = time.time()
            self.jamba_lm = build_model(cfg, use_flash=True,
                                        use_ssd_kernel=True, seed=0)
            self.torch.cuda.synchronize()
            n = sum(p.numel() for p in self.jamba_lm.parameters())
            if n != param_count(cfg) or n != JAMBA_PERIOD_PARAMS:
                fail("jamba", f"{n:,} parameters built; param_count "
                              f"{param_count(cfg):,}")
            m, s = cfg.moe, cfg.ssm
            kinds = "".join("A" if self.jamba_lm.layer_kind(i) == "attn"
                            else "M" for i in range(cfg.num_layers))
            ffn = "".join("E" if "moe" in b._modules else "D"
                          for b in self.jamba_lm.blocks)
            say("jamba", f"{cfg.name} cut to one period ({JAMBA_LAYERS} of "
                         f"32 layers; mixers {kinds}, FFNs {ffn}): d_model "
                         f"{cfg.d_model}, heads {cfg.num_heads}/"
                         f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, "
                         f"{m.num_experts} experts top-{m.experts_per_token}"
                         f" of d_ff {m.d_ff_expert}, SSM state {s.d_state}, "
                         f"head dim {s.head_dim}, expand {s.expand}; {n:,} "
                         f"parameters drawn on the card in "
                         f"{time.time() - t0:.1f} s")
        return self.jamba_lm

    def jamba(self):
        torch, Fa, Sd = self.torch, self.Fa, self.Sd
        model = self.jamba_model()
        cfg = model.cfg
        S = PREFILL_S
        tokens = self.family_tokens(cfg, 1, S)
        n_ssm = sum(model.layer_kind(i) == "ssm" for i in range(JAMBA_LAYERS))

        def last_logits(kernels):
            model.use_flash = model.use_ssd_kernel = kernels
            with torch.inference_mode():
                logits, aux = model.apply(tokens)
                out = logits[:, -1].float(), aux, tuple(logits.shape)
            model.use_flash = model.use_ssd_kernel = True
            return out

        with torch.inference_mode():
            model.apply(tokens[:, :1024])          # warm-up: cuBLAS, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Fa.flash_fwd.launches = 0                   # main path starts
        Sd.ssd_chunked.launches = 0
        t0 = time.time()
        last, aux, shape = last_logits(True)
        torch.cuda.synchronize()
        secs = time.time() - t0
        nf, ns = Fa.flash_fwd.launches, Sd.ssd_chunked.launches  # ends
        peak = torch.cuda.max_memory_allocated()
        if (nf, ns) != (JAMBA_LAYERS - n_ssm, n_ssm) or shape != (
                1, S, model.vocab_padded) or not torch.isfinite(last).all():
            fail("jamba", f"{nf} flash and {ns} SSD launches for "
                          f"{JAMBA_LAYERS - n_ssm} attention and {n_ssm} SSM "
                          f"layers, logits {shape}, finite: "
                          f"{bool(torch.isfinite(last).all())}")
        self.rates["jamba_prefill"] = (S / secs, peak)
        say("jamba", f"prefill 1 x {S} tokens: {nf} flash and {ns} SSD "
                     f"launches, {secs:.3f} s, {S / secs:,.0f} tokens/s, peak "
                     f"memory {peak / 2**30:.2f} GiB, aux loss "
                     f"{float(aux):.6g}; card {self.card}")
        torch.cuda.synchronize()
        t0 = time.time()
        last_ref, aux_ref, _ = last_logits(False)
        torch.cuda.synchronize()
        say("jamba", f"plain path (no flash, plain scan): "
                     f"{time.time() - t0:.3f} s; aux {float(aux_ref):.6g}")
        self.hold_logits("last-token logits, kernels vs plain", last,
                         last_ref, tokens[:, -1], phase="jamba")
        # layer 0's own scan inputs: the kernel against the plain scan
        saved = Sd.ssd_chunked.launches
        args = self.mamba_layer0_inputs(model, tokens)
        self.ssd_check(f"jamba layer 0's own inputs ({list(args[0].shape)}, "
                       f"N {args[2].shape[-1]}, B/C {args[2].dtype})", *args,
                       cfg.ssm.chunk_size, phase="jamba")
        Sd.ssd_chunked.launches = saved
        del args
        self.decode_against_prefill("jamba", model)
        self.family_serve("jamba", model)
        # 26 GB of weights: gone before the phases that draw danube's
        # optimizer state
        self.jamba_lm = None
        del model
        torch.cuda.empty_cache()

    # ------------------------- 17-19. the MLA, M-RoPE and encoder-decoder
    def left3_model(self, phase, arch):
        """``arch`` at full width with the flash kernel on, bf16 weights
        drawn on the card from seed 0; its parameters less the vocabulary
        pad against param_count and the reference's count."""
        from repro_torch.config import param_count
        from repro_torch.configs import registry
        from repro_torch.models import build_model
        cfg = registry.get_config(arch)
        if arch in LEFT3_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=LEFT3_LAYERS[arch])
        t0 = time.time()
        model = build_model(cfg, use_flash=True, seed=0)
        self.torch.cuda.synchronize()
        n = sum(p.numel() for p in model.parameters())
        pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model
        if n - pad != param_count(cfg) or \
                param_count(cfg) != LEFT3_PARAMS[arch]:
            fail(phase, f"{n:,} parameters built, {pad:,} of them vocab "
                        f"padding; param_count {param_count(cfg):,}")
        enc = f"{cfg.encoder_layers} encoder + " if cfg.encoder_layers else ""
        say(phase, f"{cfg.name}: {enc}{cfg.num_layers} layers, d_model "
                   f"{cfg.d_model}, heads {cfg.num_heads}/"
                   f"{cfg.num_kv_heads} of {cfg.resolved_head_dim}, "
                   f"attention {cfg.attention}, positions {cfg.pos_emb}; "
                   f"{n:,} parameters drawn on the card in "
                   f"{time.time() - t0:.1f} s: param_count "
                   f"{param_count(cfg):,} plus {pad:,} of vocab padding")
        return model

    def left3_prefill(self, phase, model, run, B, S):
        """One warm ``run(S)`` (a prefill of B x S; ``run(n)`` prefills the
        first n tokens), its flash launches counted (one a layer), tokens/s
        and peak memory.  Returns the last-token logits, float32."""
        torch, Fa = self.torch, self.Fa
        L = model.cfg.num_layers
        with torch.inference_mode():
            run(1024)                               # warm-up: cuBLAS, caches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0               # main path starts
            t0 = time.time()
            logits, _ = run(S)
            last = logits[:, -1].float()
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = Fa.flash_fwd.launches               # main path ends
            peak = torch.cuda.max_memory_allocated()
            shape = tuple(logits.shape)
            del logits
        if n != L or shape != (B, S, model.vocab_padded) or \
                not torch.isfinite(last).all():
            fail(phase, f"{n} flash launches for {L} layers, logits {shape}, "
                        f"finite: {bool(torch.isfinite(last).all())}")
        self.rates[f"{phase}_prefill"] = (B * S / secs, peak)
        say(phase, f"prefill {B} x {S} tokens: {n} flash launches, "
                   f"{secs:.3f} s, {B * S / secs:,.0f} tokens/s, peak memory "
                   f"{peak / 2**30:.2f} GiB; card {self.card}")
        return last

    def left3_attention(self, phase, what, q, k, v, d_out=None):
        """q [1, S, Hq, D], k/v [1, S, Hkv, D] bf16 through the kernel
        (launches not counted) against the chunked plain attention in
        float32: atol = rtol = 2e-2 and each row to ROW_TOL; with
        ``d_out``, the output's columns past it (V's padding) must be 0."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import ref_attention_chunked
        S = q.shape[1]
        pos = torch.arange(S, device=self.dev)[None]
        saved = Fa.flash_fwd.launches
        o_k = Fa.flash_attention(q, k, v)
        Fa.flash_fwd.launches = saved
        o_r = ref_attention_chunked(q.float(), k.float(), v.float(), pos, pos)
        torch.cuda.synchronize()
        pad_ok = d_out is None or not o_k[..., d_out:].any()
        o_k, o_r = o_k[..., :d_out], o_r[..., :d_out]
        err = (o_k.float() - o_r).abs().max().item()
        rerr = row_err(o_k, o_r)
        self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"], err)
        tol = FLASH_TOL["bfloat16"][0]
        msg = (f"{what} {list(q.shape)} x {list(k.shape)}, N(0,1) inputs: "
               f"kernel vs chunked plain max abs err {err:.3g}, row err "
               f"{rerr:.3g} (tolerance {tol}, row {ROW_TOL})"
               + ("" if d_out is None else
                  f"; the padded columns past {d_out} are 0: {pad_ok}"))
        if not torch.allclose(o_k.float(), o_r, atol=tol, rtol=tol) or \
                rerr > ROW_TOL or not pad_ok:
            fail(phase, msg)
        say(phase, msg)

    def left3_plain(self, phase, model, run):
        """The last-token logits of ``run(PLAIN_S)`` through the kernel
        against the plain path's, at the model tolerance."""
        torch = self.torch
        with torch.inference_mode():
            last = run(PLAIN_S)[0][:, -1].float()
            model.use_flash = False
            t0 = time.time()
            ref = run(PLAIN_S)[0][:, -1].float()
            torch.cuda.synchronize()
            secs = time.time() - t0
            model.use_flash = True
        err = (last - ref).abs().max().item()
        same = bool(last.argmax(-1).eq(ref.argmax(-1)).all())
        msg = (f"1 x {PLAIN_S} prefill without the kernel: {secs:.3f} s; "
               f"last-token logits flash vs plain max abs err {err:.4g} "
               f"(|logit| max {ref.abs().max().item():.4g}; atol "
               f"{MODEL_ATOL} rtol {MODEL_RTOL}), argmax agrees: {same}")
        if not torch.allclose(last, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL) \
                or not same:
            fail(phase, msg)
        say(phase, msg)

    def mla(self):
        import torch.nn.functional as F
        torch = self.torch
        model = self.left3_model("mla", "minicpm3_4b")
        cfg = model.cfg
        m = cfg.mla
        tokens = self.family_tokens(cfg, 1, PREFILL_S)
        run = lambda n: model.apply(tokens[:, :n])      # noqa: E731
        self.left3_prefill("mla", model, run, 1, PREFILL_S)
        # minicpm3's attention layout at the prefill's length: per-head
        # nope parts, one rope key shared by the heads, V padded to qk
        g = torch.Generator(device=self.dev).manual_seed(0)
        H = cfg.num_heads

        def n01(*shape):
            return torch.randn(*shape, generator=g, device=self.dev).to(
                torch.bfloat16)

        S = PREFILL_S
        k_rope = n01(1, S, 1, m.qk_rope_head_dim).expand(1, S, H, -1)
        q = torch.cat([n01(1, S, H, m.qk_nope_head_dim),
                       n01(1, S, H, m.qk_rope_head_dim)], -1)
        k = torch.cat([n01(1, S, H, m.qk_nope_head_dim), k_rope], -1)
        v = F.pad(n01(1, S, H, m.v_head_dim),
                  (0, q.shape[-1] - m.v_head_dim))
        self.left3_attention("mla", f"minicpm3's attention (D {q.shape[-1]}"
                             f", V padded {m.v_head_dim} -> {q.shape[-1]})",
                             q, k, v, d_out=m.v_head_dim)
        del q, k, v, k_rope
        self.left3_plain("mla", model, run)
        self.decode_against_prefill("mla", model, atol=MLA_DECODE_ATOL,
                                    rtol=MLA_DECODE_RTOL, every=True)
        self.family_serve("mla", model, LEFT3_REQUESTS, LEFT3_NEW)
        del model, run                  # 4.3 GB of weights
        torch.cuda.empty_cache()

    def grid_positions(self, S):
        """[1, S, 3] (t, h, w): t = arange, h and w the rows and columns of
        a grid 128 patches wide, as an image's patches take them."""
        s = self.torch.arange(S, device=self.dev)
        return self.torch.stack([s, s // 128, s % 128], -1)[None].to(
            self.torch.int32)

    def vlm(self):
        torch = self.torch
        model = self.left3_model("vlm", "qwen2_vl_2b")
        cfg = model.cfg
        S, D = PREFILL_S, cfg.resolved_head_dim
        g = torch.Generator(device=self.dev).manual_seed(0)
        emb = torch.randn(1, S, cfg.d_model, generator=g,
                          device=self.dev).to(torch.bfloat16)
        pos = self.grid_positions(S)
        run = lambda n: model.apply(embeds=emb[:, :n],     # noqa: E731
                                    positions=pos[:, :n])
        self.left3_prefill("vlm", model, run, 1, S)
        q, k, v = self.attn_inputs(1, cfg.num_heads, cfg.num_kv_heads, S, D,
                                   "bfloat16")
        self.left3_attention("vlm", f"qwen2-vl's attention (D {D}, group "
                             f"{cfg.num_heads // cfg.num_kv_heads})", q, k, v)
        del q, k, v
        self.left3_plain("vlm", model, run)
        t = torch.arange(DECODE_T, device=self.dev, dtype=torch.int32)
        self.decode_against_prefill(
            "vlm", model, positions=t[None, :, None].expand(1, DECODE_T, 3))
        self.family_serve("vlm", model, LEFT3_REQUESTS, LEFT3_NEW)
        del model, run, emb
        torch.cuda.empty_cache()

    def whisper(self):
        torch, Fa = self.torch, self.Fa
        model = self.left3_model("whisper", "whisper_large_v3")
        cfg = model.cfg
        B, S, L = WHISPER_B, WHISPER_S, cfg.num_layers
        g = torch.Generator(device=self.dev).manual_seed(0)
        frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=g,
                             device=self.dev).to(torch.bfloat16)
        tokens = self.family_tokens(cfg, B, S)
        with torch.inference_mode():
            model.apply(tokens[:2, :128], frames[:2])   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                   # main path starts
            t0 = time.time()
            logits, _ = model.apply(tokens, frames)
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = Fa.flash_fwd.launches                   # main path ends
            peak = torch.cuda.max_memory_allocated()
            model.use_flash = False
            ref, _ = model.apply(tokens, frames)
            model.use_flash = True
        if n != L or tuple(logits.shape) != (B, S, model.vocab_padded) or \
                not torch.isfinite(logits).all():
            fail("whisper", f"{n} flash launches for {L} decoder layers, "
                            f"logits {tuple(logits.shape)}, finite: "
                            f"{bool(torch.isfinite(logits).all())}")
        self.rates["whisper_prefill"] = (B * S / secs, peak)
        say("whisper", f"{B} x ({cfg.encoder_seq} frames + {S} tokens): {n} "
                       f"flash launches, {secs:.3f} s, {B * S / secs:,.0f} "
                       f"decoder tokens/s ({B * cfg.encoder_seq / secs:,.0f} "
                       f"frames/s), peak memory {peak / 2**30:.2f} GiB; card "
                       f"{self.card}")
        # at this init each row's largest logit is its input token's own
        # (tied embeddings; ~1,300 on an NVIDIA H100 80GB HBM3 at 700 W,
        # where a bf16 ulp is 8): held as logit_spread holds mamba2's (the
        # counts beyond the model tolerance reported)
        self.hold_logits("every logit, flash vs plain decoder", logits, ref,
                         tokens, phase="whisper")
        del logits, ref
        # greedy decode through init_cache / decode_step, then the same
        # tokens teacher-forced (their first 64 positions of 128 through
        # the kernel: causal, so the rest cannot reach them)
        T = WHISPER_STEPS
        with torch.inference_mode():
            t0 = time.time()
            enc = model.encode(frames)
            cache = model.init_cache(enc, T)
            tok, fed, outs = tokens[:, :1], [], []
            for t in range(T):
                fed.append(tok)
                lg, cache = model.decode_step(
                    cache, tok, torch.full((B,), t, dtype=torch.int32,
                                           device=self.dev))
                outs.append(lg[:, 0].float())
                tok = lg[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            secs = time.time() - t0
            fed = torch.cat(fed + [tokens[:, T:2 * T]], 1)
            full = model.decode_train(fed, enc)[:, :T].float()
        dec = torch.stack(outs, 1)
        self.rates["whisper_decode"] = (T / secs, B * T / secs)
        say("whisper", f"greedy decode of {T} steps x {B} rows (encode and "
                       f"cross K/V included): {secs:.2f} s, {T / secs:.1f} "
                       f"decode_step calls/s, {B * T / secs:.1f} tokens/s")
        self.hold_logits(f"{T} greedy decode_step calls vs the teacher-forced"
                         " decoder on their tokens", dec, full, fed[:, :T],
                         phase="whisper")
        del model, cache, enc
        torch.cuda.empty_cache()

    # ------------------------------------------------------- 28. goldens
    def start_goldens(self):
        """The two host-bound tick_window=1 golden runs (the tick kernel's
        and the tiled one's, ~100 s each at ~200 ticks/s), each in a
        worker process of its own, side by side (two host threads of this
        process shared its interpreter and ran at 55 ticks/s each).  The
        main loop starts them with the launch phase, whose only rate is
        taken under its flop counter, so that no phase that reports a time
        or rate shares the card and the host with them."""
        import concurrent.futures as cf
        import multiprocessing
        self.torch.cuda.empty_cache()
        self.golden_pool = cf.ProcessPoolExecutor(
            len(GOLDEN_EARLY), mp_context=multiprocessing.get_context("spawn"))
        for key in GOLDEN_EARLY:
            self.golden_futs[key] = self.golden_pool.submit(golden_task,
                                                            *key)

    def goldens(self):
        """The Table-1 goldens through each kernel route
        (:func:`golden_task`): the tick_window=1 runs from the workers
        :meth:`start_goldens` started (now, if the launch phase did not),
        the others in this process meanwhile."""
        if self.golden_pool is None:
            self.start_goldens()
        cfg = table1(self.T)[2]
        R = cfg.record_every
        # tick_window=1: a tick launch per tick; w > 1: each record period
        # runs R // w windows of w ticks and one of R % w
        # ((tick_window, blk): tick, window and tiled launches expected)
        runs = {(20, None): (0, cfg.n_ticks // R, 0),
                (7, None): (0, cfg.n_ticks // R * -(-R // 7), 0),
                (1, None): (cfg.n_ticks, 0, 0),
                (1, BLK["table1"]): (0, 0, cfg.n_ticks)}
        for (tw, blk), want in runs.items():
            early = (tw, blk) in self.golden_futs
            r = self.golden_futs.pop((tw, blk)).result() if early \
                else golden_task(tw, blk)
            if r["launches"] != want:
                fail("goldens", f"tick_window={tw} blk={blk}: "
                                f"{r['launches']} tick, window and tiled "
                                f"launches for {cfg.n_ticks} ticks")
            for k, name in enumerate(("ecmp_base", "ecmp_sym")):
                if r["job"][k] != GOLDEN_JOB[name] or \
                        r["flows"][k] != GOLDEN_FLOWS[name]:
                    fail("goldens", f"tick_window={tw} blk={blk} {name}: "
                                    f"job finish {r['job'][k]}, flows "
                                    f"{r['flows'][k]}")
            nt, nw, ntl = r["launches"]
            say("goldens", f"tick_window={tw} blk={blk}: ecmp_base "
                           f"{GOLDEN_JOB['ecmp_base']} and ecmp_sym "
                           f"{GOLDEN_JOB['ecmp_sym']} with all "
                           f"{len(r['flows'][0])} flow finish ticks; 2 "
                           f"lanes x {cfg.n_ticks} ticks, {nt} tick + {nw} "
                           f"window + {ntl} tiled launches, "
                           f"{cfg.n_ticks / r['secs']:.1f} ticks/s"
                           + (" (in a worker process beside the other "
                              "tick_window=1 run)" if early else ""))

    # --------------------------------------------- 20. 128-host, 8 lanes
    def multipod(self):
        torch, T, K, Wn = self.torch, self.T, self.K, self.Wn
        topo, wl, cfg = multipod128(T)
        seeds = list(range(8))
        cfg = cfg._replace(sym_on=True)
        eager = T.simulate_seeds(topo, wl, cfg, "ecmp", seeds,
                                 device=self.dev)
        torch.cuda.synchronize()
        for tw, kname, want in ((1, "netsim_tick", cfg.n_ticks),
                                (20, "netsim_window", cfg.n_ticks // 20)):
            counter = K.netsim_tick if tw == 1 else Wn.netsim_window
            counter.launches = 0                     # main path starts
            t0 = time.time()
            fused = T.simulate_seeds(
                topo, wl, cfg._replace(backend="cuda", tick_window=tw),
                "ecmp", seeds, device=self.dev)
            torch.cuda.synchronize()
            secs = time.time() - t0
            n = counter.launches                     # main path ends
            if n != want or n == 0:
                fail("multipod", f"tick_window={tw}: {n} {kname} launches "
                                 f"for {cfg.n_ticks} ticks")
            self.launches[kname] = n
            for f in INT_SERIES:
                if not torch.equal(getattr(eager, f), getattr(fused, f)):
                    fail("multipod", f"tick_window={tw}: cuda and eager "
                                     f"differ in {f}")
            err = (eager.ts_throughput -
                   fused.ts_throughput).abs().max().item()
            if not torch.isfinite(fused.ts_throughput).all() or \
                    not torch.allclose(eager.ts_throughput,
                                       fused.ts_throughput, rtol=RTOL_TPUT):
                fail("multipod", f"tick_window={tw}: throughput series "
                                 f"differ: {err}")
            rate = cfg.n_ticks / secs
            self.rates[("multipod128", tw)] = rate
            done = fused.ts_done_min[:, -1, 0].tolist()
            say("multipod", f"tick_window={tw}: 8 lanes x {cfg.n_ticks} "
                            "ticks, cuda == eager on every integer series "
                            f"(throughput max abs diff {err}); steps done "
                            f"per lane {done}; {n} {kname} launches; "
                            f"{rate:.1f} ticks/s ({rate * 8:.1f} "
                            "lane-ticks/s)")

    # ----------------------------------- 21. lanes split over devices
    def lanes(self):
        """The grid entry points' devices=: 128 hosts x 8 seeds (tick_window 1
        for LANES_TW1_TICKS ticks, tick_window 20 for 2,000) with the card
        named 2 and 3 times (3: shares of 3, 3 and 2 lanes), and Table 1's four (sym_on, pq_on) points
        with chunk_knobs=1 over 2 entries (2 points a dispatch, 1 a
        device; 20,000 ticks, tick_window 20), each against the one-device
        run; a planted fault there (shares renumbering their lanes, so the
        second runs the first's knob point) must fail."""
        import repro_torch.core.netsim.simulator as sim
        torch, T = self.torch, self.T
        auto = T.resolve_grid_mesh(devices="auto")
        say("lanes", f"resolve_grid_mesh(devices='auto') on "
                     f"{torch.cuda.device_count()} card(s): {auto!r}")
        topo, wl, cfg = multipod128(T)
        seeds = list(range(8))
        dev = self.dev
        for tw in (1, 20):
            c = cfg._replace(sym_on=True, backend="cuda", tick_window=tw,
                             n_ticks=LANES_TW1_TICKS if tw == 1
                             else cfg.n_ticks)
            torch.cuda.synchronize()
            t0 = time.time()
            one = T.simulate_seeds(topo, wl, c, "ecmp", seeds, device=dev)
            torch.cuda.synchronize()
            t_one = time.time() - t0
            for n in LANE_SPLITS:
                t0 = time.time()
                got = T.simulate_seeds(topo, wl, c, "ecmp", seeds,
                                       devices=[dev] * n)
                torch.cuda.synchronize()
                t_split = time.time() - t0
                ok, msg = lane_split_check(torch, got, one)
                if not ok:
                    fail("lanes", f"tick_window={tw}, 8 lanes over {n} "
                                  f"entries: {msg}")
                self.rates[("lanes", tw, n)] = (t_one, t_split)
                say("lanes", f"128 hosts, tick_window={tw}, {c.n_ticks} "
                             f"ticks, 8 lanes over the card named {n} "
                             f"times vs one device: "
                             f"{msg}; wall {t_split:.2f} s split, "
                             f"{t_one:.2f} s on one device")
        topo, wl, cfg = table1(T)
        c = cfg._replace(backend="cuda", tick_window=20)
        knobs = lane_knobs(T, c)
        one = T.simulate_grid(topo, wl, c.structure(), knobs, [3],
                              chunk_knobs=1, device=dev)
        t0 = time.time()
        got = T.simulate_grid(topo, wl, c.structure(), knobs, [3],
                              chunk_knobs=1, devices=[dev, dev])
        torch.cuda.synchronize()
        ok, msg = lane_split_check(torch, got, one)
        for k, name in enumerate(("ecmp_base", "ecmp_sym")):
            if int(got.job_finish_ticks[k, 0, 0]) != GOLDEN_JOB[name] or \
                    got.finish_ticks[k, 0].tolist() != GOLDEN_FLOWS[name]:
                ok, msg = False, msg + f"; {name} misses its golden"
        if not ok:
            fail("lanes", f"Table 1, chunk_knobs=1 over 2 entries: {msg}")
        say("lanes", f"Table 1, 4 points x seed 3, chunk_knobs=1 over 2 "
                     f"entries (2 dispatches of 2 lanes) vs one device: "
                     f"{msg}; the ecmp_base and ecmp_sym goldens hold; "
                     f"{time.time() - t0:.2f} s")
        with renumbered_shares(sim):
            bad = T.simulate_grid(topo, wl, c.structure(), knobs, [3],
                                  chunk_knobs=1, devices=[dev, dev])
        ok, msg = lane_split_check(torch, bad, one)
        if ok:
            fail("lanes", "a split whose shares renumber their lanes passed "
                          "the check")
        say("lanes", f"planted fault (each dispatch's second share runs its "
                     f"first lane's point): {msg}; fails, as it must")

    # ------------------------------------- 22. explicit ring collectives
    def ring(self):
        """The ring collectives over the card named 4 and 8 times, each case
        bit-equal to the same call over CPU ranks and within its tolerance
        of the plain sum, ppermute counts 2(N-1) per ring per channel; two
        planted faults; the 256 MiB all-reduce timed."""
        torch = self.torch
        import repro_torch.collectives.ring as ring_mod
        from repro_torch.collectives import ring_all_reduce
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.spmd import P, shard_map
        dev = self.dev
        for n in RING_RANKS:
            t0 = time.time()
            got = ring_cases(torch, [dev] * n, n, big=True)
            t_dev = time.time() - t0
            t0 = time.time()
            want = ring_cases(torch, ["cpu"] * n, n, big=True)
            t_cpu = time.time() - t0
            worst = {}
            for name, case in got.items():
                y, counts, wanted, plain, tol = case
                if counts != wanted:
                    fail("ring", f"{n} ranks, {name}: ppermute counts "
                                 f"{counts}, want {wanted}")
                if not torch.equal(y, want[name][0]):
                    fail("ring", f"{n} ranks, {name}: the card's result "
                                 "differs from CPU ranks' in "
                                 f"{int((y != want[name][0]).sum())} of "
                                 f"{y.numel()} elements")
                if not ring_case_ok(case):
                    fail("ring", f"{n} ranks, {name}: outside {tol} of "
                                 "the plain sum")
                if plain is not None:
                    worst[name] = float((y.float() - plain.float()).abs()
                                        .max())
            err = max(v for k, v in worst.items() if "int8" not in k)
            int8 = [v for k, v in worst.items() if "int8" in k]
            say("ring", f"{n} ranks (the card named {n} times): {len(got)} "
                        f"cases bit-equal to CPU ranks, ppermute counts 2(N-1)"
                        f" per ring per channel; max |error| against the "
                        f"plain sum {err:.3g} (int8-compressed hierarchy "
                        f"{int8[0]:.3g}, reported); {t_dev:.1f} s on the "
                        f"card, {t_cpu:.1f} s on CPU ranks")
        mesh = make_mesh((8,), ("data",), [dev] * 8)
        g = torch.Generator().manual_seed(99)
        x = torch.randn(8, 16, generator=g)
        plain = x.sum(0, keepdim=True)
        for fault in ("shifted by two", "last step dropped"):
            with planted_ring(ring_mod, fault):
                y = shard_map(lambda a: ring_all_reduce(a, "data"), mesh=mesh,
                              in_specs=P("data"), out_specs=P())(x).cpu()
            if torch.allclose(y, plain, rtol=RING_TOL[0], atol=RING_TOL[1]):
                fail("ring", f"planted fault ({fault}) passed the check")
            say("ring", f"planted fault ({fault}): max |error| "
                        f"{float((y - plain).abs().max()):.3g}; fails, as it "
                        "must")
        for n in RING_RANKS:
            self.ring_timing(n)

    def ring_timing(self, n: int):
        """The RING_BIG-element float32 all-reduce over the card named n
        times, CUDA events around the whole call (host included), beside
        one stack(...).sum(0) of the same shards on the card."""
        torch = self.torch
        from repro_torch.collectives import ring_all_reduce
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.spmd import P, shard_map
        mesh = make_mesh((n,), ("data",), [self.dev] * n)
        x = torch.randn(n, RING_BIG, device=self.dev)
        fn = shard_map(lambda a: ring_all_reduce(a, "data"), mesh=mesh,
                       in_specs=P("data"), out_specs=P())
        shards = list(x.unbind(0))

        def events(call, reps=3):
            call()
            ms = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            return sorted(ms)[len(ms) // 2]

        ring_ms = events(lambda: fn(x))
        plain_ms = events(lambda: torch.stack(shards).sum(0))
        nbytes = RING_BIG * 4
        bus = 2 * (n - 1) / n * nbytes / (ring_ms * 1e-3) / 1e9
        self.rates[("ring", n)] = (ring_ms, plain_ms)
        say("ring", f"{n} ranks, {nbytes / 2**20:.0f} MiB float32 a rank: "
                    f"ring_all_reduce {ring_ms:.3f} ms (median of 3, CUDA "
                    f"events around the call; {bus:.1f} GB/s of ring "
                    f"traffic a rank), one stack(...).sum(0) of the same "
                    f"shards {plain_ms:.3f} ms; card {self.card}")
        del x, shards

    # ------------------------------- 23. data-parallel training, 4 ranks
    def dp(self):
        """danube at full width cut to DP_LAYERS layers, trained with ring
        then hierarchical gradient sync over the card named 4 times."""
        torch = self.torch
        from repro_torch.config import LM_SHAPES, param_count
        from repro_torch.configs import registry
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (make_parallel_config,
                                              make_train_config)
        from repro_torch.models import build_model
        from repro_torch.runtime import make_train_step
        arch = "h2o_danube_3_4b"
        cfg = dataclasses.replace(registry.get_config(arch),
                                  num_layers=DP_LAYERS)
        if param_count(cfg) != DP_PARAMS:
            fail("dp", f"param_count {param_count(cfg):,}, want "
                       f"{DP_PARAMS:,}")
        spec = next(sp for sp in LM_SHAPES if sp.name == "train_4k")
        tcfg = dataclasses.replace(make_train_config(arch, spec),
                                   global_batch=DP_B)
        par = dataclasses.replace(make_parallel_config(arch, "train_4k"),
                                  grad_sync="ring")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, par, use_flash=True, seed=0)
        data = SyntheticLM(DataConfig(cfg.vocab_size, spec.seq_len, DP_B,
                                      seed=0))
        batches = []
        for s in range(DP_STEPS):
            toks, labs = data.batch(s)
            batches.append({"tokens": torch.from_numpy(toks).to(self.dev),
                            "labels": torch.from_numpy(labs).to(self.dev)})
        say("dp", f"{cfg.name} at full width cut to {DP_LAYERS} of 24 "
                  f"layers: {DP_PARAMS:,} parameters (param_count) drawn on "
                  f"the card; remat {par.remat}, AdamW float32 m/v and "
                  f"master weights; SyntheticLM {DP_B} x {spec.seq_len}")
        # step 0's synced gradients against one device's on the whole batch
        params = dict(model.named_parameters())
        mesh = make_mesh((4,), ("data",), [self.dev] * 4)
        step = make_train_step(model, cfg, tcfg, par, mesh)
        ring_loss, synced = step.grads(batches[0])
        same = all(torch.equal(g[k], synced[0][k])
                   for g in synced[1:] for k in params)
        ring = [synced[0][k].float() for k in params]
        whole_loss, rel = self.dp_references(model, batches[0], ring)
        worst = {k: max(rel[k], key=rel[k].get) for k in rel}
        if not same or rel["float32"][worst["float32"]] > DP_GRAD_REL_L2 \
                or rel["rows"][worst["rows"]] > DP_ROWS_REL_L2 or \
                abs(float(ring_loss) - whole_loss) > DP_LOSS_ABS:
            leaves = [(k, v, rel[k][v]) for k, v in worst.items()]
            fail("dp", f"ring-synced step 0: ranks bit-equal {same}; worst "
                       f"leaves {leaves}; losses {float(ring_loss)} vs "
                       f"{whole_loss}")
        say("dp", f"step 0's ring-synced gradients: the 4 ranks' bit-equal; "
                  f"against one device's on the whole {DP_B} x "
                  f"{spec.seq_len} batch in float32 at most "
                  f"{rel['float32'][worst['float32']]:.3g} rel L2 "
                  f"({worst['float32']}; tolerance {DP_GRAD_REL_L2}), against"
                  f" the mean of one device's {DP_B} one-row bf16 gradients "
                  f"at most {rel['rows'][worst['rows']]:.3g} "
                  f"({worst['rows']}; tolerance {DP_ROWS_REL_L2:.3g}: the "
                  f"synced mean's bf16 rounding); the whole batch's bf16 "
                  f"gradients read {rel['bf16'][worst['bf16']]:.3g} "
                  f"({worst['bf16']}), themselves "
                  f"{rel['bf16~float32'][worst['bf16']]:.3g} from float32 "
                  f"there; loss {float(ring_loss):.5f} vs {whole_loss:.5f}")
        del ring
        sync_ms = self.dp_sync_ms(step, synced, "ring")
        del synced
        self.dp_steps(step, "ring", mesh, batches, flash_ops, sync_ms)
        del step
        mesh = make_mesh((2, 2), ("pod", "data"), [self.dev] * 4)
        par = dataclasses.replace(par, grad_sync="hierarchical")
        step = make_train_step(model, cfg, tcfg, par, mesh)
        _, synced = step.grads(batches[0])
        sync_ms = self.dp_sync_ms(step, synced, "hierarchical")
        del synced
        self.dp_steps(step, "hierarchical", mesh, batches, flash_ops,
                      sync_ms)
        del step, model, params
        torch.cuda.empty_cache()

    def dp_references(self, model, batch, ring) -> tuple[float, dict]:
        """One device's gradients that ring-synced ones (``ring``, float32
        copies, in parameter order) are held to: the whole batch through a
        float32 copy of the model (what the sync computes, without bf16
        gradients' roundings), the mean of the batch's one-row bf16
        gradients (what the ranks compute, summed in float32), and the
        whole batch in bf16 (reported: the tied embedding's bf16 gradient
        over the whole batch is itself off).  Returns (the whole batch's
        bf16 loss, {reference: {leaf: relative L2 distance}})."""
        torch = self.torch
        from repro_torch.models.model import replicate
        from repro_torch.models.params import cast_tree
        from repro_torch.runtime import make_loss_fn
        names = [n for n, _ in model.named_parameters()]

        def grads(m, b):
            loss = make_loss_fn(m, m.cfg)(b)
            g = torch.autograd.grad(loss, list(m.parameters()))
            return float(loss.detach()), [x.float() for x in g]

        def rel(a, b):
            return {n: float((x - y).norm() / y.norm().clamp_min(1e-30))
                    for n, x, y in zip(names, a, b)}

        out = {}
        rows = None
        for i in range(batch["tokens"].shape[0]):
            _, g = grads(model, {k: v[i:i + 1] for k, v in batch.items()})
            rows = g if rows is None else [a + b for a, b in zip(rows, g)]
        n = torch.full((), float(batch["tokens"].shape[0]), device=self.dev)
        out["rows"] = rel(ring, [r / n for r in rows])
        del rows
        loss, bf16 = grads(model, batch)
        out["bf16"] = rel(ring, bf16)
        f32 = replicate(model, self.dev)
        cast_tree(f32, torch.float32)
        f32.cfg = dataclasses.replace(model.cfg, dtype="float32")
        _, whole = grads(f32, batch)
        del f32
        out["float32"] = rel(ring, whole)
        out["bf16~float32"] = rel(bf16, whole)
        return loss, out

    def dp_sync_ms(self, step, grads, mode) -> float:
        """One sync_grads_local of the ranks' gradients, as the step runs it,
        timed with CUDA events (median of 3 after a warm-up)."""
        torch = self.torch
        from repro_torch.collectives import sync_grads_local
        from repro_torch.parallel.spmd import P, axis_index, shard_map
        axes = step.data_axes

        def local():
            sync_grads_local(grads[axis_index(axes)], axes, mode=mode,
                             channels=step.par.ring_buckets,
                             bidirectional=step.par.ring_bidirectional)

        fn = shard_map(local, mesh=step.mesh, in_specs=(), out_specs=P(),
                       axis_names=axes)
        fn()
        ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sorted(ms)[1]

    def dp_steps(self, step, mode, mesh, batches, flash_ops, sync_ms):
        """DP_STEPS steps of ``step``; replicas bit-equal after each; flash
        calls per rank (by the ranks' streams)."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.optim import init_opt_state
        from repro_torch.parallel import spmd
        model = step.replicas[0]
        opt = init_opt_state(dict(model.named_parameters()), step.tcfg)
        Fa.flash_fwd.launches = 0                     # main path starts
        Fa.flash_bwd.launches_dq = Fa.flash_bwd.launches_dkv = 0
        losses, ms = [], []
        with flash_calls_by_stream(torch, flash_ops) as calls:
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.time()
                opt, met = step(opt, b)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.time() - t0))
                losses.append(float(met["loss"]))
                first = list(step.replicas[0].parameters())
                for r, rep in enumerate(step.replicas[1:], 1):
                    diff = [i for i, (a, c) in enumerate(zip(
                        first, rep.parameters())) if not torch.equal(a, c)]
                    if diff:
                        fail("dp", f"{mode} step {len(ms) - 1}: replica {r} "
                                   f"differs from rank 0 in {len(diff)} "
                                   "leaves")
        n_fwd = Fa.flash_fwd.launches                 # main path ends
        n_dq, n_dkv = Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv
        rank_of = {s.cuda_stream: key[0] for key, s in spmd.rank_streams(mesh).items()}
        per_rank = {r: (0, 0) for r in range(len(step.replicas))}
        for (kind, sid), c in calls.items():
            r = rank_of.get(sid, -1)
            f, b = per_rank.get(r, (0, 0))
            per_rank[r] = (f + c, b) if kind == "fwd" else (f, b + c)
        L = len(model.blocks)
        want = (2 * L * len(batches), L * len(batches))
        n = len(step.replicas)
        if any(per_rank[r] != want for r in range(n)) or len(per_rank) != n \
                or (n_fwd, n_dq, n_dkv) != (n * want[0], n * want[1],
                                            n * want[1]):
            fail("dp", f"{mode}: flash calls per rank (forward, backward) "
                       f"{per_rank}, want {want} on each of {n}; launches "
                       f"{n_fwd} forward, {n_dq} dq, {n_dkv} dk/dv")
        if not all(x == x and abs(x) != float("inf") for x in losses):
            fail("dp", f"{mode}: losses {losses}")
        self.launches[("dp", mode)] = (n_fwd, n_dq, n_dkv)
        peak = torch.cuda.max_memory_allocated()
        tokens = len(batches) * step.tcfg.global_batch * \
            batches[0]["tokens"].shape[1]
        self.rates[("dp", mode)] = (ms, sync_ms, peak)
        say("dp", f"{mode} sync over {dict(mesh.shape)} ({n} replicas on "
                  f"the card): {len(batches)} steps, losses "
                  f"{[round(x, 4) for x in losses]}; replicas bit-equal "
                  f"after every step; flash per rank {want[0]} forward "
                  f"(forward and remat recompute) and {want[1]} backward "
                  f"calls, {n_fwd} forward, {n_dq} dq, {n_dkv} dk/dv "
                  f"launches in all; ms a step "
                  f"{[round(x, 1) for x in ms]} ({tokens / sum(ms) * 1e3:,.0f}"
                  f" tokens/s), the sync alone {sync_ms:.1f} ms; peak "
                  f"memory {peak / 2**30:.2f} GiB; card {self.card}")

    # ----------------------------- 24. expert-parallel dispatch, 8 ranks
    def ep(self):
        """granite's layer-0 MoE at full width over (data 2, model 4) on
        the card named 8 times: at capacity 8.0 against the one-device
        path, at its own 1.25 twice (bit-equal), drops reported."""
        torch = self.torch
        import repro_torch.models.moe as moe
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.sharding import make_rules
        model = self.granite_model()
        cfg = model.cfg
        p = {k: v.detach() for k, v in model.blocks[0].moe.items()}
        g = torch.Generator(device=self.dev).manual_seed(5)
        x = torch.randn(EP_B, EP_S, cfg.d_model, generator=g,
                        device=self.dev).to(torch.bfloat16)
        mesh = make_mesh((2, 4), ("data", "model"), [self.dev] * 8)
        rules = make_rules()
        cf8 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        with torch.no_grad():
            t0 = time.time()
            y1, a1 = moe.moe_block(p, x, cf8)
            torch.cuda.synchronize()
            t1 = time.time()
            with ep_drop_counter(moe) as drops8:
                y8, a8 = moe.moe_block(p, x, cf8, rules, mesh)
            torch.cuda.synchronize()
            t8 = time.time()
        rel = float((y8.float() - y1.float()).norm() / y1.float().norm())
        bits = int((y8.view(torch.int16) != y1.view(torch.int16)).sum())
        lost = int(torch.stack(drops8["send"] + drops8["expert"]).sum())
        if rel > BF16_REL_L2 or lost or not torch.isfinite(y8).all():
            fail("ep", f"capacity 8.0: EP vs one device rel L2 {rel}, "
                       f"{lost} assignments dropped")
        say("ep", f"{cfg.name} layer 0 MoE ({cfg.moe.num_experts} experts "
                  f"top-{cfg.moe.experts_per_token}, d_model {cfg.d_model}),"
                  f" {EP_B} x {EP_S} N(0,1) bf16 tokens over (data 2, model "
                  f"4), the card named 8 times: at capacity 8.0 nothing "
                  f"drops and the output is within {rel:.3g} rel L2 of the "
                  f"one-device path ({bits} of {y1.numel()} elements' bits "
                  f"differ; tolerance {BF16_REL_L2}); aux {float(a8):.6g} "
                  f"(pmean of the ranks') vs {float(a1):.6g}; "
                  f"{1e3 * (t8 - t1):.1f} ms EP, {1e3 * (t1 - t0):.1f} ms "
                  f"one device (wall, first calls)")
        del y1, y8
        outs = []
        with torch.no_grad():
            for _ in range(2):
                with ep_drop_counter(moe) as drops:
                    torch.cuda.synchronize()
                    t0 = time.time()
                    y, aux = moe.moe_block(p, x, cfg, rules, mesh)
                    torch.cuda.synchronize()
                    outs.append((y, time.time() - t0, {
                        k: int(torch.stack(v).sum()) for k, v in
                        drops.items()}))
        (ya, ta, da), (yb, tb, db) = outs
        if not torch.equal(ya, yb) or da != db or \
                not torch.isfinite(ya).all():
            fail("ep", f"capacity {cfg.moe.capacity_factor}: two runs differ "
                       f"(drops {da} vs {db})")
        n_assign = EP_B * EP_S * cfg.moe.experts_per_token
        say("ep", f"at granite's capacity {cfg.moe.capacity_factor}: two runs"
                  f" bit-equal; of {n_assign:,} assignments {da['send']:,} "
                  f"dropped at the send buffers' capacity and "
                  f"{da['expert']:,} at the experts'; {1e3 * tb:.1f} ms a "
                  f"run (wall, second); card {self.card}")
        self.rates["ep"] = (1e3 * tb, da)

    # ------------------------------------------ 25. GPipe over 4 stages
    def gpipe(self):
        """4 stages of one danube block each at full width over the card
        named 4 times, GPIPE_MB microbatches of 1 x TRAIN_S: each
        microbatch's output bit-equal to the blocks applied in turn."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.pipeline import run_pipelined
        model = self.danube_model()
        cfg = model.cfg
        blocks = [model.blocks[i] for i in range(GPIPE_STAGES)]
        stages = stacked_blocks(torch, blocks)
        g = torch.Generator(device=self.dev).manual_seed(6)
        x = torch.randn(GPIPE_MB, TRAIN_S, cfg.d_model, generator=g,
                        device=self.dev).to(torch.bfloat16)
        pos = torch.arange(TRAIN_S, dtype=torch.int32,
                           device=self.dev).expand(1, TRAIN_S)
        mesh = make_mesh((GPIPE_STAGES,), ("pod",), [self.dev] * GPIPE_STAGES)

        def layer_fn(sp, h):
            return danube_block(cfg, {k: {n: t[0] for n, t in v.items()}
                                      for k, v in sp.items()}, h, pos)

        with torch.no_grad():
            run_pipelined(mesh, layer_fn, stages, x, GPIPE_MB)   # warm-up
            torch.cuda.synchronize()
            Fa.flash_fwd.launches = 0                 # main path starts
            t0 = time.time()
            got = run_pipelined(mesh, layer_fn, stages, x, GPIPE_MB)
            torch.cuda.synchronize()
            t_pipe = time.time() - t0
            n_fwd = Fa.flash_fwd.launches             # main path ends
            t0 = time.time()
            want = []
            for i in range(GPIPE_MB):
                h = x[i:i + 1]
                for j, bp in enumerate(blocks):
                    h, _ = model._apply_block(bp, j, h, pos)
                want.append(h)
            torch.cuda.synchronize()
            t_seq = time.time() - t0
        ticks = GPIPE_MB + GPIPE_STAGES - 1
        same = [torch.equal(got[i:i + 1], want[i]) for i in range(GPIPE_MB)]
        if not all(same) or n_fwd != ticks * GPIPE_STAGES:
            fail("gpipe", f"microbatches bit-equal {same}; {n_fwd} flash "
                          f"launches, want {ticks * GPIPE_STAGES}")
        self.rates["gpipe"] = (t_pipe, t_seq)
        say("gpipe", f"{GPIPE_STAGES} stages of one {cfg.name} block each "
                     f"(full width), the card named {GPIPE_STAGES} times, "
                     f"{GPIPE_MB} microbatches of 1 x {TRAIN_S}: every "
                     f"microbatch bit-equal to the blocks applied in turn on "
                     f"one device; {ticks} ticks, {n_fwd} flash launches "
                     f"(every stage every tick: bubble "
                     f"{(GPIPE_STAGES - 1) / ticks:.2f}); "
                     f"{1e3 * t_pipe:.1f} ms pipelined, {1e3 * t_seq:.1f} ms "
                     f"in turn (wall); card {self.card}")
        del stages, got, want

    # ------------------------------ 26. tensor parallelism over the card
    def tp(self):
        """danube's, granite's, mamba2's and minicpm3's tensor-parallel
        training steps and prefills (jamba's first period's prefill) over
        the card named 8 and 4 times, each against one device; one MoE
        layer inside the ranks against the EP path, jamba's layer 0 against
        one device; the flash and SSD kernels at the ranks' shapes."""
        self.tp_train()
        self.tp_prefill()
        self.tp_family_train(TP_MOE)
        self.tp_moe_prefill()
        self.tp_moe_layer()
        self.tp_family_train(TP_SSM)
        self.tp_ssm_prefill()
        self.tp_hybrid_prefill()
        self.tp_hybrid_layer()
        self.tp_family_train(TP_MLA)
        self.tp_mla_prefill()
        self.tp_kernels()
        self.tp_moe_kernels()
        self.tp_ssm_kernels()
        self.tp_mla_kernels()

    def tp_grads(self, model, batch):
        """One device's float32 loss and gradients (parameter order)."""
        from repro_torch.runtime import make_loss_fn
        loss = make_loss_fn(model, model.cfg)(batch)
        g = self.torch.autograd.grad(loss, list(model.parameters()))
        return float(loss.detach()), [x.detach() for x in g]

    def tp_train(self):
        torch, Fa = self.torch, self.Fa
        from repro_torch.config import LM_SHAPES
        from repro_torch.configs import registry
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (make_parallel_config,
                                              make_train_config)
        from repro_torch.models import build_model
        from repro_torch.models.model import make_model, replicate
        from repro_torch.models.params import cast_tree
        from repro_torch.optim import init_opt_state
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import gather_shards, make_rules
        from repro_torch.runtime import make_train_step
        arch = "h2o_danube_3_4b"
        cfg = dataclasses.replace(registry.get_config(arch),
                                  num_layers=DP_LAYERS, dtype="float32")
        spec = next(sp for sp in LM_SHAPES if sp.name == "train_4k")
        tcfg = dataclasses.replace(make_train_config(arch, spec),
                                   global_batch=TP_B)
        par = make_parallel_config(arch, "train_4k")
        n = TP_MESH[0] * TP_MESH[1]
        mesh = make_mesh(TP_MESH, ("data", "model"), [self.dev] * n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = cast_tree(build_model(cfg, par, use_flash=True, seed=0,
                                      mesh=mesh), torch.float32)
        one = replicate(model, self.dev, one_device=True)
        init = [p.detach().clone() for p in model.parameters()]
        names = [k for k, _ in model.named_parameters()]
        toks, labs = SyntheticLM(DataConfig(cfg.vocab_size, spec.seq_len,
                                            TP_B, seed=0)).batch(0)
        batch = {"tokens": torch.from_numpy(toks).to(self.dev),
                 "labels": torch.from_numpy(labs).to(self.dev)}
        say("tp", f"{cfg.name} at full width cut to {DP_LAYERS} of 24 layers"
                  f" on {dict(mesh.shape)} (the card named {n} times), "
                  f"float32, {sum(p.numel() for p in init):,} parameters "
                  f"(heads {model.blocks[0].attn['wq'].shape[1]} padded "
                  f"for tp {model.tp}, vocabulary {model.vocab_padded}); "
                  f"remat {par.remat}; SyntheticLM {TP_B} x {spec.seq_len};"
                  f" against one device's step on the same padded tree")

        def fresh(m):
            opt = init_opt_state(dict(m.named_parameters()), tcfg)
            return opt._replace(step=torch.full_like(opt.step,
                                                     tcfg.warmup_steps))

        loss1, g1 = self.tp_grads(one, batch)
        _, met1 = make_train_step(one, cfg, tcfg, par)(fresh(one), batch)
        upd1 = [p.detach() - q for p, q in zip(one.parameters(), init)]
        del one
        torch.cuda.empty_cache()
        rel = functools.partial(finite_rel, torch)
        for mode, fsdp in (("xla", False), ("xla", True), ("ring", False)):
            what = f"grad_sync {mode}" + (", FSDP" if fsdp else "")
            p_mode = dataclasses.replace(par, grad_sync=mode, fsdp=fsdp)
            m = model if not fsdp else cast_tree(make_model(
                cfg, p_mode, True, device=self.dev, mesh=mesh,
                rules=make_rules(fsdp=True)), torch.float32)
            with torch.no_grad():
                for p, q in zip(m.parameters(), init):
                    p.copy_(q)
            step = make_train_step(m, cfg, tcfg, p_mode, mesh)
            loss, grads = step.grads(batch)
            specs = m.param_specs()
            worst = max((rel(gather_shards([g[k] for g in grads], specs[k],
                                           mesh), g1[i]), k)
                        for i, k in enumerate(names))
            sync_ms = self.tp_sync_ms(step, grads)
            del grads
            opt = fresh(m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                 # main path starts
            Fa.flash_bwd.launches_dq = Fa.flash_bwd.launches_dkv = 0
            spmd.TALLY.clear()
            with flash_calls_by_stream(torch, flash_ops) as calls:
                t0 = time.time()
                opt, met = step(opt, batch)
                torch.cuda.synchronize()
                ms = 1e3 * (time.time() - t0)
            n_fwd = Fa.flash_fwd.launches             # main path ends
            n_bwd = (Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv)
            kinds = spmd.TALLY.by_kind()
            peak = torch.cuda.max_memory_allocated()
            upd = max((rel(p.detach() - q, u), k) for k, p, q, u in zip(
                names, m.parameters(), init, upd1))
            L = len(m.blocks)
            l_rel = abs(float(met["loss"]) / float(met1["loss"]) - 1)
            n_rel = abs(float(met["grad_norm"]) / float(met1["grad_norm"]) - 1)
            rank_of = {st.cuda_stream: key[0]
                       for key, st in spmd.rank_streams(mesh).items()}
            per_rank = collections.Counter()
            for (kind, sid), c in calls.items():
                per_rank[(rank_of.get(sid, -1), kind)] += c
            want = {(r, kind): c for r in range(n)
                    for kind, c in (("fwd", 2 * L), ("bwd", L))}
            if not (worst[0] <= TP_GRAD_REL_L2 and l_rel <= TP_LOSS_RTOL
                    and n_rel <= TP_LOSS_RTOL and
                    upd[0] <= TP_UPDATE_REL_L2) or \
                    n_fwd != 2 * L * n or n_bwd != (L * n, L * n) or \
                    dict(per_rank) != want or len(kinds) < 2:
                fail("tp", f"{what}: calls per (rank, kind) "
                           f"{dict(per_rank)}; worst gradient {worst}, losses "
                           f"{float(met['loss'])} / {float(met1['loss'])}, "
                           f"norms {float(met['grad_norm'])} / "
                           f"{float(met1['grad_norm'])}, worst update {upd};"
                           f" flash launches {n_fwd} forward, {n_bwd} "
                           f"backward (want {2 * L * n}, {L * n}); "
                           f"collectives {kinds}")
            self.launches[("tp", what)] = (n_fwd,) + n_bwd
            self.rates[("tp", what)] = (ms, sync_ms, peak)
            say("tp", f"{what}: loss {float(met['loss']):.6f} (one device "
                      f"{float(met1['loss']):.6f}, {l_rel:.2g} rel), grad "
                      f"norm {float(met['grad_norm']):.6f} ({n_rel:.2g} "
                      f"rel), worst gradient {worst[0]:.3g} rel L2 "
                      f"({worst[1]}; tolerance {TP_GRAD_REL_L2}), worst "
                      f"update {upd[0]:.3g} ({upd[1]}; tolerance "
                      f"{TP_UPDATE_REL_L2}); collectives {kinds}; flash "
                      f"{n_fwd} forward (forward and recompute), {n_bwd[0]} "
                      f"dq, {n_bwd[1]} dk/dv launches ({2 * L} forward and "
                      f"{L} backward calls on each rank's stream); "
                      f"{ms:.1f} ms a step ("
                      f"{TP_B * spec.seq_len / ms * 1e3:,.0f} tokens/s), "
                      f"the sync {sync_ms:.1f} ms; peak memory "
                      f"{peak / 2**30:.2f} GiB; card {self.card}")
            del step, opt
            if m is not model:
                del m
            torch.cuda.empty_cache()
        del model, init, g1, upd1
        torch.cuda.empty_cache()

    def tp_sync_ms(self, step, grads) -> float:
        """The step's gradient sync (sync_grads_tp over every rank, on the
        ranks' ``grads`` from ``step.grads``) timed with CUDA events,
        median of 3."""
        torch = self.torch
        from repro_torch.collectives.scheduler import sync_grads_tp
        from repro_torch.parallel import spmd

        def local():
            sync_grads_tp(grads[spmd.rank_index()], step.specs,
                          step.data_axes, mode=step.par.grad_sync,
                          mean=False)

        fn = spmd.shard_map(local, mesh=step.mesh, in_specs=(),
                            out_specs=spmd.P())
        ms = []
        with torch.no_grad():
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
        return sorted(ms)[1]

    def tp_prefill(self):
        torch, Fa = self.torch, self.Fa
        from repro_torch.configs import registry
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        from repro_torch.models.attention import tp_kv_heads
        cfg = registry.get_config("h2o_danube_3_4b")
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, use_flash=True, seed=0, mesh=mesh)
        g = torch.Generator(device=self.dev).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S),
                               generator=g, device=self.dev)
        with torch.no_grad():
            model.apply(tokens[:, :1024])     # the ranks' blocks, warm
            torch.cuda.synchronize()
            Fa.flash_fwd.launches = 0                 # main path starts
            with flash_calls_by_stream(torch, flash_ops) as calls:
                t0 = time.time()
                logits, _ = model.apply(tokens)
                torch.cuda.synchronize()
                secs = time.time() - t0
            launches = Fa.flash_fwd.launches          # main path ends
            last = logits[:, -1, :cfg.vocab_size].float()
            del logits
            peak = torch.cuda.max_memory_allocated()
            mesh_, model.mesh = model.mesh, None  # one device, same tree
            try:
                ref, _ = model.apply(tokens)
            finally:
                model.mesh = mesh_
            last_ref = ref[:, -1, :cfg.vocab_size].float()
            del ref
        gap = logit_gap(last, last_ref)
        per = sorted(c for (kind, _), c in calls.items() if kind == "fwd")
        hl = model.blocks[0].attn["wq"].shape[1] // n
        nk = tp_kv_heads(hl, hl * n, cfg.num_kv_heads, 0)[1]
        L = cfg.num_layers
        if launches != L * n or per != [L] * n or not torch.allclose(
                last, last_ref, atol=MODEL_ATOL, rtol=MODEL_RTOL):
            fail("tp", f"prefill: {launches} flash launches (per rank "
                       f"{per}, want {L} on each of {n}); last-token logits "
                       f"against one device: {gap}")
        self.launches[("tp", "prefill")] = launches
        self.rates[("tp", "prefill")] = (PREFILL_S / secs, peak)
        say("tp", f"prefill {cfg.name} ({L} layers) 1 x {PREFILL_S} on "
                  f"{dict(mesh.shape)}: {launches} flash launches ({per} a "
                  f"rank, {hl} q heads and {nk} KV heads a rank), "
                  f"{secs:.3f} s "
                  f"({PREFILL_S / secs:,.0f} tokens/s), last-token logits "
                  f"against the one-device flash route (atol {MODEL_ATOL}, "
                  f"rtol {MODEL_RTOL}): {gap}; peak memory "
                  f"{peak / 2**30:.2f} GiB (the model, the ranks' blocks "
                  f"and the assembled logits); card {self.card}")
        del model, tokens, last, last_ref
        torch.cuda.empty_cache()

    def tp_family_train(self, arch):
        """``arch`` (TP_MOE, TP_SSM or TP_MLA) at full width cut to DP_LAYERS
        layers, float32, on TP_MESH: one step of the tensor-parallel
        make_train_step with grad_sync "xla", then "ring", each against
        one device's step on the same tree (a MoE model at TP_MOE_CF, its
        aux the mesh program's), its collectives by kind against
        tp_family_counts."""
        torch, Fa = self.torch, self.Fa
        import repro_torch.models.lm as lm_mod
        import repro_torch.models.moe as moe
        from repro_torch.config import LM_SHAPES
        from repro_torch.configs import registry
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import (make_parallel_config,
                                              make_train_config)
        from repro_torch.models import build_model
        from repro_torch.models.model import replicate
        from repro_torch.models.params import cast_tree
        from repro_torch.optim import adamw_update, init_opt_state
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import gather_shards, spec_axes
        from repro_torch.runtime import make_train_step
        base = registry.get_config(arch)
        cfg = dataclasses.replace(base, num_layers=DP_LAYERS, dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=TP_MOE_CF))
        spec = next(sp for sp in LM_SHAPES if sp.name == "train_4k")
        tcfg = dataclasses.replace(make_train_config(arch, spec),
                                   global_batch=TP_B)
        par = make_parallel_config(arch, "train_4k")
        dp, tp = TP_MESH
        n = dp * tp
        mesh = make_mesh(TP_MESH, ("data", "model"), [self.dev] * n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = cast_tree(build_model(cfg, par, use_flash=True, seed=0,
                                      mesh=mesh), torch.float32)
        one = replicate(model, self.dev, one_device=True)
        init = [p.detach().clone() for p in model.parameters()]
        names = [k for k, _ in model.named_parameters()]
        toks, labs = SyntheticLM(DataConfig(cfg.vocab_size, spec.seq_len,
                                            TP_B, seed=0)).batch(0)
        batch = {"tokens": torch.from_numpy(toks).to(self.dev),
                 "labels": torch.from_numpy(labs).to(self.dev)}
        T = TP_B // dp * spec.seq_len // tp
        chunks = T // min(moe.DISPATCH_CHUNK, T) if cfg.moe else 0
        L = len(model.blocks)
        n_attn = sum(model.layer_kind(i) == "attn" for i in range(L))
        n_moe = sum("moe" in b._modules for b in model.blocks)
        n_mlp = sum("mlp" in b._modules for b in model.blocks)
        n_mla = n_attn if cfg.attention == "mla" else 0
        if cfg.moe is not None:
            wi = model.blocks[0].moe["wi"]
            what_is = (f"{cfg.moe.num_experts} experts, {wi.shape[0] // tp}"
                       f" a rank; heads {cfg.num_heads}/{cfg.num_kv_heads} "
                       f"of {cfg.resolved_head_dim}, vocabulary "
                       f"{model.vocab_padded}); capacity factor "
                       f"{TP_MOE_CF}; {T} tokens a rank, {chunks} dispatch "
                       "chunk(s)")
        elif cfg.attention == "mla":
            wq_b = model.blocks[0].attn["wq_b"]
            what_is = (f"MLA: q_lora {wq_b.shape[0]}, {wq_b.shape[0] // tp}"
                       f" a rank; heads {wq_b.shape[1]} of {wq_b.shape[2]}, "
                       f"{wq_b.shape[1] // tp} a rank; kv_lora "
                       f"{cfg.mla.kv_lora_rank} whole; vocabulary "
                       f"{model.vocab_padded})")
        else:
            wz = model.blocks[0].ssm["wz"]
            what_is = (f"{wz.shape[1]} SSM heads of {wz.shape[2]}, "
                       f"{wz.shape[1] // tp} a rank, state "
                       f"{cfg.ssm.d_state}; vocabulary {model.vocab_padded})"
                       "; the plain scan (the SSD kernel is forward only)")
        say("tp", f"{cfg.name} at full width cut to {DP_LAYERS} of "
                  f"{base.num_layers} layers on {dict(mesh.shape)} (the card "
                  f"named {n} times), float32, "
                  f"{sum(p.numel() for p in init):,} parameters ({what_is}"
                  f"; remat {par.remat}; SyntheticLM {TP_B} x "
                  f"{spec.seq_len}; against one device's step on the same "
                  f"tree" + (", its aux the ranks' mean" if cfg.moe else ""))

        def fresh(m):
            opt = init_opt_state(dict(m.named_parameters()), tcfg)
            return opt._replace(step=torch.full_like(opt.step,
                                                     tcfg.warmup_steps))

        with mesh_aux(torch, lm_mod, moe, dp, tp), \
                moe_drop_counter(moe) as d1, route_log(torch, moe) as r1:
            loss1, g1 = self.tp_grads(one, batch)
        with torch.no_grad():           # one device's step on its gradients
            _, met1 = adamw_update(dict(one.named_parameters()),
                                   dict(zip(names, g1)), fresh(one), tcfg)
        met1["loss"] = torch.tensor(loss1)
        lost1 = int(torch.stack(d1).sum()) if d1 else 0
        upd1 = [p.detach() - q for p, q in zip(one.parameters(), init)]
        del one
        torch.cuda.empty_cache()
        rel = functools.partial(finite_rel, torch)
        specs = model.param_specs()
        replicated = sum("model" not in spec_axes(sp)
                         for sp in specs.values())
        for mode in ("xla", "ring"):
            what = f"{cfg.name} grad_sync {mode}"
            p_mode = dataclasses.replace(par, grad_sync=mode)
            with torch.no_grad():
                for p, q in zip(model.parameters(), init):
                    p.copy_(q)
            step = make_train_step(model, cfg, tcfg, p_mode, mesh)
            opt = fresh(model)
            # the step's own synced gradients, held to one device's below
            held, grads_of = {}, step.grads

            def keep(b):
                held["loss"], held["grads"] = grads_of(b)
                return held["loss"], held["grads"]

            step.grads = keep
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                 # main path starts
            Fa.flash_bwd.launches_dq = Fa.flash_bwd.launches_dkv = 0
            spmd.TALLY.clear()
            with flash_calls_by_stream(torch, flash_ops) as calls, \
                    ep_drop_counter(moe) as dm, route_log(torch, moe) as rm:
                t0 = time.time()
                opt, met = step(opt, batch)
                torch.cuda.synchronize()
                ms = 1e3 * (time.time() - t0)
            n_fwd = Fa.flash_fwd.launches             # main path ends
            n_bwd = (Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv)
            kinds = spmd.TALLY.by_kind()
            peak = torch.cuda.max_memory_allocated()
            del step.grads              # no cycle through keep: freed below
            grads = held.pop("grads")
            lost = int(torch.stack(dm["send"] + dm["expert"]).sum()) \
                if dm["send"] else 0
            worst = max((rel(gather_shards([g[k] for g in grads], specs[k],
                                           mesh), g1[i]), k)
                        for i, k in enumerate(names))
            # routing: a token whose top-k set differs from one device's
            # moves the router's gradient; one device's smallest gap
            # between a token's k-th and (k+1)-th probability says how near
            # a tie the routing came
            flips, gaps = route_flips(
                torch, r1.forward[None], rm.forward, n_moe, TP_B,
                spec.seq_len, dp, tp) if n_moe else ([], [])
            routing = (f"tokens whose top-k differs from one device's per "
                       f"MoE layer {flips}, one device's smallest top-k "
                       f"probability gap per layer "
                       f"{[float(f'{g:.3g}') for g in gaps]}, tokens whose "
                       f"remat recompute routed otherwise than the forward "
                       f"{remat_flips(torch, rm)} over the ranks, "
                       f"{remat_flips(torch, r1)} on one device; ") \
                if n_moe else ""
            sync_ms = self.tp_sync_ms(step, grads)
            del grads
            upd = max((rel(p.detach() - q, u), k) for k, p, q, u in zip(
                names, model.parameters(), init, upd1))
            want_kinds = tp_family_counts(
                L, chunks, spec.seq_len // 1024, len(names), replicated,
                mode, n_mlp, n_mla)
            l_rel = abs(float(met["loss"]) / float(met1["loss"]) - 1)
            n_rel = abs(float(met["grad_norm"]) / float(met1["grad_norm"]) - 1)
            rank_of = {st.cuda_stream: key[0]
                       for key, st in spmd.rank_streams(mesh).items()}
            per_rank = collections.Counter()
            for (kind, sid), c in calls.items():
                per_rank[(rank_of.get(sid, -1), kind)] += c
            want = {(r, kind): c for r in range(n)
                    for kind, c in (("fwd", 2 * n_attn), ("bwd", n_attn))
                    if c}
            if not (worst[0] <= TP_GRAD_REL_L2 and l_rel <= TP_LOSS_RTOL
                    and n_rel <= TP_LOSS_RTOL and
                    upd[0] <= TP_UPDATE_REL_L2) or \
                    n_fwd != 2 * n_attn * n or \
                    n_bwd != (n_attn * n, n_attn * n) or \
                    dict(per_rank) != want or kinds != want_kinds or \
                    lost or lost1:
                fail("tp", f"{what}: {routing}calls per (rank, kind) "
                           f"{dict(per_rank)}; worst gradient {worst}, losses "
                           f"{float(met['loss'])} / {float(met1['loss'])}, "
                           f"norms {float(met['grad_norm'])} / "
                           f"{float(met1['grad_norm'])}, worst update {upd};"
                           f" flash launches {n_fwd} forward, {n_bwd} "
                           f"backward (want {2 * n_attn * n}, "
                           f"{n_attn * n}); collectives {kinds} (want "
                           f"{want_kinds}); assignments dropped {lost} over "
                           f"the ranks, {lost1} on one device")
            self.launches[("tp", what)] = (n_fwd,) + n_bwd
            self.rates[("tp", what)] = (ms, sync_ms, peak)
            flash = (f"flash {n_fwd} forward, {n_bwd[0]} dq, {n_bwd[1]} "
                     f"dk/dv launches (the float32 kernels; {2 * n_attn} "
                     f"forward and {n_attn} backward calls on each rank's "
                     "stream)") if n_attn else "no attention layer"
            say("tp", f"{what}: loss {float(met['loss']):.6f} (one device "
                      f"{float(met1['loss']):.6f}, {l_rel:.2g} rel), grad "
                      f"norm {float(met['grad_norm']):.6f} ({n_rel:.2g} "
                      f"rel), worst gradient {worst[0]:.3g} rel L2 "
                      f"({worst[1]}; tolerance {TP_GRAD_REL_L2}), worst "
                      f"update {upd[0]:.3g} ({upd[1]}; tolerance "
                      f"{TP_UPDATE_REL_L2}); "
                      + ("no assignment dropped; " if cfg.moe else "")
                      + routing
                      + f"collectives {kinds}, the CPU ranks' derivation "
                      f"(tp_family_counts); {flash}; {ms:.1f} ms a step ("
                      f"{TP_B * spec.seq_len / ms * 1e3:,.0f} tokens/s), the "
                      f"sync {sync_ms:.1f} ms; peak memory "
                      f"{peak / 2**30:.2f} GiB; card {self.card}")
            del step, opt
            torch.cuda.empty_cache()
        del model, init, g1, upd1
        torch.cuda.empty_cache()

    def tp_moe_prefill(self):
        """granite at full width cut to TP_MOE_PREFILL_LAYERS layers
        prefilling 1 x PREFILL_S
        tokens on TP_PREFILL_MESH through the flash forward at a rank's
        heads, against the one-device flash route on the same tree; each
        layer's dropped assignments on both sides."""
        torch, Fa = self.torch, self.Fa
        import repro_torch.models.moe as moe
        from repro_torch.configs import registry
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        from repro_torch.models.attention import tp_kv_heads
        cfg = dataclasses.replace(registry.get_config(TP_MOE),
                                  num_layers=TP_MOE_PREFILL_LAYERS)
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, use_flash=True, seed=0, mesh=mesh)
        g = torch.Generator(device=self.dev).manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_S),
                               generator=g, device=self.dev)
        L = cfg.num_layers
        with torch.no_grad():
            model.apply(tokens[:, :1024])     # the ranks' blocks, warm
            torch.cuda.synchronize()
            Fa.flash_fwd.launches = 0                 # main path starts
            with flash_calls_by_stream(torch, flash_ops) as calls, \
                    ep_drop_counter(moe) as dm:
                t0 = time.time()
                logits, aux = model.apply(tokens)
                torch.cuda.synchronize()
                secs = time.time() - t0
            launches = Fa.flash_fwd.launches          # main path ends
            last = logits[:, -1, :cfg.vocab_size].float()
            del logits
            peak = torch.cuda.max_memory_allocated()
            mesh_, model.mesh = model.mesh, None  # one device, same tree
            try:
                with moe_drop_counter(moe) as d1:
                    ref, aux1 = model.apply(tokens)
            finally:
                model.mesh = mesh_
            last_ref = ref[:, -1, :cfg.vocab_size].float()
            del ref
        hl = model.blocks[0].attn["wq"].shape[1] // n
        nk = tp_kv_heads(hl, hl * n, cfg.num_kv_heads, 0)[1]
        sent = per_layer(torch, dm["send"], L)
        kept = per_layer(torch, dm["expert"], L)
        mesh_drops = [a + b for a, b in zip(sent, kept)]
        one_drops = per_layer(torch, d1, L)
        gap = logit_gap(last, last_ref)
        per = sorted(c for (kind, _), c in calls.items() if kind == "fwd")
        if launches != L * n or per != [L] * n or not torch.allclose(
                last, last_ref, atol=MODEL_ATOL, rtol=MODEL_RTOL) or \
                not math.isfinite(float(aux)):
            fail("tp", f"{cfg.name} prefill: {launches} flash launches (per "
                       f"rank {per}, want {L} on each of {n}); last-token "
                       f"logits against one device: {gap}; aux "
                       f"{float(aux)}")
        self.launches[("tp", "granite prefill")] = launches
        self.rates[("tp", "granite prefill")] = (PREFILL_S / secs, peak)
        n_assign = PREFILL_S * cfg.moe.experts_per_token
        say("tp", f"prefill {cfg.name} ({L} layers) 1 x {PREFILL_S} on "
                  f"{dict(mesh.shape)}: {launches} flash launches ({per} a "
                  f"rank, {hl} q heads and {nk} KV heads a rank), "
                  f"{secs:.3f} s ({PREFILL_S / secs:,.0f} tokens/s), "
                  f"last-token logits against the one-device flash route "
                  f"(atol {MODEL_ATOL}, rtol {MODEL_RTOL}): {gap}; aux "
                  f"{float(aux):.6g} (ranks' mean) vs "
                  f"{float(aux1):.6g} (one device); of {n_assign:,} "
                  f"assignments a layer, dropped over the ranks (send + "
                  f"experts) {mesh_drops}, on one device {one_drops} "
                  f"(capacity {cfg.moe.capacity_factor}); peak memory "
                  f"{peak / 2**30:.2f} GiB; card {self.card}")
        del model, tokens, last, last_ref
        torch.cuda.empty_cache()

    def tp_moe_layer(self):
        """granite's layer-0 moe_block at full width on 1 x PREFILL_S
        N(0,1) bf16 tokens over TP_PREFILL_MESH: inside the ranks of a
        shard_map (the tensor-parallel rank's path, moe_rank: router
        whole, E / 4 experts a rank, the rank's sequence shard) against
        the EP path outside a rank (_moe_mesh), at granite's capacity
        factor and at 1.0, where rows drop: bit-equal, the same drops."""
        torch = self.torch
        import repro_torch.models.moe as moe
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import spmd
        from repro_torch.parallel.sharding import make_rules
        model = self.granite_model()
        p = {k: v.detach() for k, v in model.blocks[0].moe.items()}
        g = torch.Generator(device=self.dev).manual_seed(6)
        x = torch.randn(1, PREFILL_S, model.cfg.d_model, generator=g,
                        device=self.dev).to(torch.bfloat16)
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        rules = make_rules()
        for cf in (model.cfg.moe.capacity_factor, 1.0):
            cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
                model.cfg.moe, capacity_factor=cf))
            inside = spmd.shard_map(
                lambda pl, xl: moe.moe_block(pl, xl, cfg, rules, mesh),
                mesh=mesh, in_specs=({"router": spmd.P(),
                                      "wi": spmd.P("model"),
                                      "wo": spmd.P("model")},
                                     spmd.P(None, "model")),
                out_specs=(spmd.P(None, "model"), spmd.P()))
            with torch.no_grad():
                with ep_drop_counter(moe) as d_out:
                    want, a_want = moe.moe_block(p, x, cfg, rules, mesh)
                with ep_drop_counter(moe) as d_in:
                    torch.cuda.synchronize()
                    t0 = time.time()
                    got, a_got = inside(p, x)
                    torch.cuda.synchronize()
                    secs = time.time() - t0
            drops = [{k: int(torch.stack(v).sum()) for k, v in d.items()}
                     for d in (d_in, d_out)]
            rel = float((got.float() - want.float()).norm() /
                        want.float().norm())
            bits = int((got.view(torch.int16) !=
                        want.view(torch.int16)).sum())
            if rel > 2.0 ** -8 or drops[0] != drops[1] or \
                    not torch.isfinite(got).all() or \
                    (cf == 1.0 and not sum(drops[0].values())) or \
                    abs(float(a_got) - float(a_want)) > \
                    1e-6 * abs(float(a_want)):
                fail("tp", f"{cfg.name} layer 0 inside the ranks at "
                           f"capacity {cf}: rel L2 {rel} against the EP "
                           f"path, drops {drops}, aux {float(a_got)} / "
                           f"{float(a_want)}")
            say("tp", f"{cfg.name} layer 0 moe_block inside the ranks of "
                      f"{dict(mesh.shape)} (router whole, "
                      f"{cfg.moe.num_experts // n} experts a rank) on 1 x "
                      f"{PREFILL_S} N(0,1) bf16 tokens, capacity {cf}: "
                      f"{bits} of {got.numel()} elements' bits differ from "
                      f"the EP path outside a rank (rel L2 {rel:.3g}; "
                      f"tolerance 2^-8), aux {float(a_got):.6g} / "
                      f"{float(a_want):.6g}; of "
                      f"{PREFILL_S * cfg.moe.experts_per_token:,} "
                      f"assignments dropped (send, experts) {drops[0]} on "
                      f"both; {1e3 * secs:.1f} ms (wall); card {self.card}")
            del got, want
        del x

    def tp_ssm_prefill(self):
        """mamba2's 24 layers at full width prefilling 1 x PREFILL_S tokens
        on TP_PREFILL_MESH through the SSD kernel at a rank's heads, in
        float32 and in bf16, each against the one-device route (the SSD
        kernel on all heads) on the same tree."""
        torch, Sd = self.torch, self.Sd
        import repro_torch.models.ssm as ssm_mod
        from repro_torch.configs import registry
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        cfg = registry.get_config(TP_SSM)
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        model = build_model(cfg, use_ssd_kernel=True, seed=0, mesh=mesh)
        tokens = self.family_tokens(cfg, 1, PREFILL_S)
        L, V = cfg.num_layers, cfg.vocab_size
        heads = model.blocks[0].ssm["wz"].shape[1]

        def run(m):
            """(rows TP_ROWS of the ranks' logits, of one device's; SSD
            launches and calls per stream of the ranks' prefill; its
            seconds and peak)."""
            with torch.no_grad():
                m.apply(tokens[:, :1024])     # the ranks' blocks, warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                Sd.ssd_chunked.launches = 0           # main path starts
                with ssd_calls_by_stream(torch, ssm_mod) as calls:
                    t0 = time.time()
                    logits, _ = m.apply(tokens)
                    torch.cuda.synchronize()
                    secs = time.time() - t0
                launches = Sd.ssd_chunked.launches    # main path ends
                peak = torch.cuda.max_memory_allocated()
                rows = logits[0, TP_ROWS, :V].float()
                del logits
                m._ranks = None
                mesh_, m.mesh = m.mesh, None  # one device, same tree
                try:
                    ref, _ = m.apply(tokens)
                finally:
                    m.mesh = mesh_
                ref_rows = ref[0, TP_ROWS, :V].float()
                del ref
            return rows, ref_rows, launches, sorted(calls.values()), secs, \
                peak

        with as_float32(model) as m32:
            rows, ref_rows, launches, per, secs, peak = run(m32)
        err = (rows - ref_rows).abs().max().item()
        ok32 = bool(torch.isfinite(rows).all()) and torch.allclose(
            rows, ref_rows, atol=F32_ATOL, rtol=F32_RTOL)
        if launches != L * n or per != [L] * n or not ok32:
            fail("tp", f"{cfg.name} prefill in float32: {launches} SSD "
                       f"launches (per rank {per}, want {L} on each of {n});"
                       f" logits max abs err {err} against one device")
        self.launches[("tp", "mamba2 prefill")] = launches
        self.rates[("tp", "mamba2 prefill")] = (PREFILL_S / secs, peak)
        say("tp", f"prefill {cfg.name} ({L} layers) 1 x {PREFILL_S} on "
                  f"{dict(mesh.shape)} in float32: {launches} SSD launches "
                  f"({per} a rank, {heads // n} of {heads} heads a rank), "
                  f"{secs:.3f} s ({PREFILL_S / secs:,.0f} tokens/s), "
                  f"{rows.shape[0]} rows of logits max abs err {err:.3g} "
                  f"against the one-device kernel route (|logit| max "
                  f"{ref_rows.abs().max().item():.4g}; atol {F32_ATOL}, "
                  f"rtol {F32_RTOL}); peak memory {peak / 2**30:.2f} GiB; "
                  f"card {self.card}")
        rows, ref_rows, launches, per, secs, peak = run(model)
        worst, same = rows_agree(torch, rows, ref_rows)
        if launches != L * n or per != [L] * n or worst > ROW_TOL or \
                same < 1 or not bool(torch.isfinite(rows).all()):
            fail("tp", f"{cfg.name} prefill in bf16: {launches} SSD launches"
                       f" (per rank {per}); worst row error {worst} "
                       f"(tolerance {ROW_TOL}), argmax agrees on {same:.1%}"
                       " of the rows")
        say("tp", f"prefill {cfg.name} in bf16 on {dict(mesh.shape)}: "
                  f"{launches} SSD launches ({per} a rank), {secs:.3f} s "
                  f"({PREFILL_S / secs:,.0f} tokens/s); {rows.shape[0]} rows"
                  f" of logits against one device: worst row error "
                  f"{worst:.3g} of the row's max |logit| (tolerance "
                  f"{ROW_TOL}), argmax agrees on {same:.0%}; peak memory "
                  f"{peak / 2**30:.2f} GiB; card {self.card}")
        del model, tokens, rows, ref_rows
        torch.cuda.empty_cache()

    def tp_hybrid_prefill(self):
        """jamba's first period at full width (the jamba phase's model,
        drawn anew from seed 0 if that phase freed it) prefilling 1 x
        PREFILL_S tokens in bf16 on TP_PREFILL_MESH with the flash and SSD
        kernels at a rank's heads, against the one-device kernel route on
        the same tree: rows TP_ROWS by row error and argmax, drops per MoE
        layer on both sides at the config's capacity factor."""
        torch, Fa, Sd = self.torch, self.Fa, self.Sd
        import repro_torch.models.moe as moe
        import repro_torch.models.ssm as ssm_mod
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        # two copies of jamba's 26 GB of weights need the room: the other
        # families' models go (later phases draw them anew from seed 0)
        self.danube = self.granite = self.mamba_lm = None
        torch.cuda.empty_cache()
        model = self.jamba_model()
        cfg = model.cfg
        L, V = cfg.num_layers, cfg.vocab_size
        n_attn = sum(model.layer_kind(i) == "attn" for i in range(L))
        n_moe = sum("moe" in b._modules for b in model.blocks)
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        tokens = self.family_tokens(cfg, 1, PREFILL_S)
        # one device first: its rows kept before the ranks' blocks (a
        # second copy of the 26 GB of weights) are cut
        with torch.no_grad(), moe_drop_counter(moe) as d1:
            ref, aux1 = model.apply(tokens)
            ref_rows = ref[0, TP_ROWS, :V].float()
            del ref
        one_drops = per_layer(torch, d1, n_moe)
        tpm = on_mesh(model, mesh)
        with torch.no_grad():
            tpm.apply(tokens[:, :1024])       # the ranks' blocks, warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                 # main path starts
            Sd.ssd_chunked.launches = 0
            with flash_calls_by_stream(torch, flash_ops) as fcalls, \
                    ssd_calls_by_stream(torch, ssm_mod) as scalls, \
                    ep_drop_counter(moe) as dm:
                t0 = time.time()
                logits, aux = tpm.apply(tokens)
                torch.cuda.synchronize()
                secs = time.time() - t0
            nf, ns = Fa.flash_fwd.launches, Sd.ssd_chunked.launches  # ends
            peak = torch.cuda.max_memory_allocated()
            rows = logits[0, TP_ROWS, :V].float()
            del logits
        tpm._ranks = None
        del tpm
        torch.cuda.empty_cache()
        fper = sorted(c for (kind, _), c in fcalls.items() if kind == "fwd")
        sper = sorted(scalls.values())
        sent = per_layer(torch, dm["send"], n_moe)
        kept = per_layer(torch, dm["expert"], n_moe)
        mesh_drops = [a + b for a, b in zip(sent, kept)]
        worst, same = rows_agree(torch, rows, ref_rows)
        n_ssm = L - n_attn
        if (nf, ns) != (n_attn * n, n_ssm * n) or fper != [n_attn] * n or \
                sper != [n_ssm] * n or worst > ROW_TOL or same < 1 or \
                not bool(torch.isfinite(rows).all()) or \
                not math.isfinite(float(aux)):
            fail("tp", f"{cfg.name} prefill: {nf} flash and {ns} SSD "
                       f"launches (per rank {fper} and {sper}, want "
                       f"{n_attn} and {n_ssm} on each of {n}); worst row "
                       f"error {worst} (tolerance {ROW_TOL}), argmax agrees"
                       f" on {same:.1%} of the rows; aux {float(aux)}")
        self.launches[("tp", "jamba prefill")] = (nf, ns)
        self.rates[("tp", "jamba prefill")] = (PREFILL_S / secs, peak)
        wz = model.blocks[0].ssm["wz"]
        n_assign = PREFILL_S * cfg.moe.experts_per_token
        say("tp", f"prefill {cfg.name} (one period, {L} layers) 1 x "
                  f"{PREFILL_S} on {dict(mesh.shape)}, bf16: {nf} flash and "
                  f"{ns} SSD launches ({fper} and {sper} a rank; "
                  f"{cfg.num_heads // n} q heads, {wz.shape[1] // n} SSM "
                  f"heads and {cfg.moe.num_experts // n} experts a rank), "
                  f"{secs:.3f} s ({PREFILL_S / secs:,.0f} tokens/s); "
                  f"{rows.shape[0]} rows of logits against the one-device "
                  f"kernel route: worst row error {worst:.3g} of the row's "
                  f"max |logit| (tolerance {ROW_TOL}), argmax agrees on "
                  f"{same:.0%}; aux {float(aux):.6g} (ranks' mean) vs "
                  f"{float(aux1):.6g} (one device); of {n_assign:,} "
                  f"assignments a MoE layer, dropped over the ranks (send + "
                  f"experts) {mesh_drops}, on one device {one_drops} "
                  f"(capacity {cfg.moe.capacity_factor}); peak memory "
                  f"{peak / 2**30:.2f} GiB (both copies of the weights); "
                  f"card {self.card}")
        del tokens, rows, ref_rows

    def tp_hybrid_layer(self):
        """jamba's layer 0 (an SSM layer and an MLP) at full width in
        float32 on 1 x PREFILL_S N(0,1) tokens: the tensor-parallel rank's
        program inside the ranks of TP_PREFILL_MESH (the SSM mixer on the
        rank's heads through the SSD kernel, the column- and row-parallel
        MLP, each partial product summed over model) against one device,
        within TP_LAYER_REL_L2; then the jamba model is freed."""
        torch, Sd = self.torch, self.Sd
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.layers import apply_mlp, apply_norm
        from repro_torch.models.ssm import ssm_block
        from repro_torch.parallel import spmd
        model = self.jamba_model()
        cfg = dataclasses.replace(model.cfg, dtype="float32")
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        specs = on_mesh(model, mesh).param_specs()
        bp = model.blocks[0]
        subs = ("ln1", "ssm", "ln2", "mlp")
        p = {sub: {k: v.detach().float() for k, v in bp._modules[sub].items()}
             for sub in subs}
        in_specs = {sub: {k: specs[f"blocks.0.{sub}.{k}"] for k in p[sub]}
                    for sub in subs}
        g = torch.Generator(device=self.dev).manual_seed(7)
        x = torch.randn(1, PREFILL_S, cfg.d_model, generator=g,
                        device=self.dev)

        def layer(q, h, total=lambda t: t):
            h = h + total(ssm_block(q["ssm"], apply_norm(q["ln1"], h, cfg),
                                    cfg, True))
            return h + total(apply_mlp(q["mlp"], apply_norm(q["ln2"], h, cfg),
                                       cfg))

        inside = spmd.shard_map(
            lambda q, h: layer(q, h, lambda t: spmd.psum(t, "model")),
            mesh=mesh, in_specs=(in_specs, spmd.P()), out_specs=spmd.P())
        saved = Sd.ssd_chunked.launches
        with torch.no_grad():
            want = layer(p, x)
            torch.cuda.synchronize()
            t0 = time.time()
            got = inside(p, x)
            torch.cuda.synchronize()
            secs = time.time() - t0
        calls = Sd.ssd_chunked.launches - saved - 1
        Sd.ssd_chunked.launches = saved
        rel = float((got - want).norm() / want.norm())
        if rel > TP_LAYER_REL_L2 or calls != n or \
                not bool(torch.isfinite(got).all()):
            fail("tp", f"{cfg.name} layer 0 inside the ranks in float32: rel"
                       f" L2 {rel} against one device (tolerance "
                       f"{TP_LAYER_REL_L2}); {calls} SSD calls (want {n})")
        say("tp", f"{cfg.name} layer 0 (SSM, {p['ssm']['wz'].shape[1] // n} "
                  f"of {p['ssm']['wz'].shape[1]} heads a rank, and an MLP of "
                  f"{p['mlp']['wo'].shape[0] // n} of "
                  f"{p['mlp']['wo'].shape[0]} columns a rank) inside the "
                  f"ranks of {dict(mesh.shape)} in float32 on 1 x "
                  f"{PREFILL_S} N(0,1) tokens: rel L2 {rel:.3g} against one "
                  f"device (tolerance {TP_LAYER_REL_L2}); {calls} SSD calls;"
                  f" {1e3 * secs:.1f} ms (wall); card {self.card}")
        del p, x, got, want
        # 26 GB of weights: gone before the launch phase
        self.jamba_lm = None
        del model, bp
        torch.cuda.empty_cache()

    def tp_ssm_kernels(self):
        """The SSD kernel at the model-4 ranks' shapes of the mamba2 and
        jamba prefills, and the flash forward at jamba's rank shape (8 q
        heads, 2 KV heads, D 128, causal): each held to its plain version
        on the same inputs (SSD at SSD_TOL, flash as the flash phase holds
        the main shape) and timed beside it, with its bound (flash also
        beside one causal SDPA call)."""
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        for (B, S, H, P, N, Q), who in ((SSD_MAIN, "tp rank mamba2"),
                                        (JAMBA_SSD, "tp rank jamba")):
            self.timing_ssd((1, S, H // n, P, N, Q), model=who, phase="tp")
        self.tp_flash_fwd("jamba", 32 // n, 8 // n, 128)

    def tp_mla_prefill(self):
        """minicpm3 at full width cut to LEFT3_LAYERS' 31 of 62 layers
        prefilling 1 x PREFILL_S tokens in bf16 on TP_PREFILL_MESH through
        the flash forward at a rank's heads (10 of 40, D 96), against the
        one-device flash route on the same tree: rows TP_ROWS by row error
        and argmax."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.configs import registry
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import build_model
        cfg = dataclasses.replace(registry.get_config(TP_MLA),
                                  num_layers=LEFT3_LAYERS[TP_MLA])
        n = TP_PREFILL_MESH[0] * TP_PREFILL_MESH[1]
        mesh = make_mesh(TP_PREFILL_MESH, ("data", "model"), [self.dev] * n)
        model = build_model(cfg, use_flash=True, seed=0, mesh=mesh)
        tokens = self.family_tokens(cfg, 1, PREFILL_S)
        L, V = cfg.num_layers, cfg.vocab_size
        wq_b = model.blocks[0].attn["wq_b"]
        with torch.no_grad():
            model.apply(tokens[:, :1024])     # the ranks' blocks, warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            Fa.flash_fwd.launches = 0                 # main path starts
            with flash_calls_by_stream(torch, flash_ops) as calls:
                t0 = time.time()
                logits, _ = model.apply(tokens)
                torch.cuda.synchronize()
                secs = time.time() - t0
            launches = Fa.flash_fwd.launches          # main path ends
            peak = torch.cuda.max_memory_allocated()
            rows = logits[0, TP_ROWS, :V].float()
            del logits
            model._ranks = None
            mesh_, model.mesh = model.mesh, None  # one device, same tree
            try:
                ref, _ = model.apply(tokens)
            finally:
                model.mesh = mesh_
            ref_rows = ref[0, TP_ROWS, :V].float()
            del ref
        per = sorted(c for (kind, _), c in calls.items() if kind == "fwd")
        worst, same = rows_agree(torch, rows, ref_rows)
        if launches != L * n or per != [L] * n or worst > ROW_TOL or \
                same < 1 or not bool(torch.isfinite(rows).all()):
            fail("tp", f"{cfg.name} prefill in bf16: {launches} flash "
                       f"launches (per rank {per}, want {L} on each of {n})"
                       f"; worst row error {worst} (tolerance {ROW_TOL}), "
                       f"argmax agrees on {same:.1%} of the rows")
        self.launches[("tp", "minicpm3 prefill")] = launches
        self.rates[("tp", "minicpm3 prefill")] = (PREFILL_S / secs, peak)
        say("tp", f"prefill {cfg.name} ({L} of 62 layers) 1 x {PREFILL_S} on"
                  f" {dict(mesh.shape)} in bf16: {launches} flash launches "
                  f"({per} a rank; q_lora {wq_b.shape[0] // n} of "
                  f"{wq_b.shape[0]} and {wq_b.shape[1] // n} of "
                  f"{wq_b.shape[1]} heads a rank), {secs:.3f} s "
                  f"({PREFILL_S / secs:,.0f} tokens/s); {rows.shape[0]} rows"
                  f" of logits against the one-device flash route: worst "
                  f"row error {worst:.3g} of the row's max |logit| "
                  f"(tolerance {ROW_TOL}), argmax agrees on {same:.0%}; "
                  f"peak memory {peak / 2**30:.2f} GiB (the model, the "
                  f"ranks' blocks and the assembled logits); card "
                  f"{self.card}")
        del model, tokens, rows, ref_rows
        torch.cuda.empty_cache()

    def tp_kernels(self):
        """The flash kernels at a tensor-parallel rank's shapes (danube at
        model 4: 8 q heads, 2 KV heads, D 120, bf16): the forward at the
        prefill's (S 32,768, window 8,192) beside one call of the chunked
        plain version and one scaled_dot_product_attention call (window
        mask), the backward pair at the training rank's (B 2, S 4,096)
        beside the plain backward and one SDPA backward."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import flash_or_ref
        hq, hkv, D, w, item = 8, 2, 120, 8192, 2
        q, k, v = self.attn_inputs(1, hq, hkv, PREFILL_S, D, "bfloat16")
        views = [x.transpose(1, 2) for x in (q, k, v)]
        saved = Fa.flash_fwd.launches
        k_dev, k_wall = timed(lambda: Fa.flash_fwd(*views, window=w), 10,
                              torch)
        Fa.flash_fwd.launches = saved
        S = PREFILL_S
        pos = torch.arange(S, device=self.dev)[None]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        flash_or_ref(q, k, v, pos, pos, window=w)
        b.record()
        torch.cuda.synchronize()
        p_ms = a.elapsed_time(b)
        lib = self.sdpa_ms(q, k, v, w)
        pairs = sum(min(i + 1, w) for i in range(S))
        self.report(f"tp rank S={S}", "flash_fwd", "flash_fwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:44",
                    k_dev, k_wall, p_ms, p_ms,
                    item * S * D * (2 * hq + 2 * hkv) + 4 * hq * S,
                    4 * D * pairs * hq, 1, peak=BF16_OPS_PER_S,
                    library_ms=lib,
                    note=f"(a model-4 rank: BH={hq}, KV heads {hkv}, D={D}, "
                         f"window {w}, bf16; plain: one call of the chunked "
                         "plain version; library: window mask)")
        del q, k, v, views
        B, S = TP_B // TP_MESH[0], TRAIN_S
        q, k, v, o, lse, do = self.bwd_inputs(B, hq, hkv, S, D, "bfloat16",
                                              w)
        views = [x.transpose(1, 2) for x in (q, k, v, o, do)]
        call = Fa.BwdCall(*views[:4], lse, views[4], window=w, causal=True)
        saved = (Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv)
        dq_dev, dq_wall = timed(call.dq, 10, torch)
        dkv_dev, dkv_wall = timed(call.dkv, 10, torch)
        Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv = saved
        lib = self.sdpa_bwd_ms(q, k, v, do)
        flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                for x in (q, k, v, o, do)]
        p_dev, p_wall = timed(lambda: Fa.attention_bwd_ref(
            *flat[:4], lse.reshape(-1, S), flat[4], window=w), 1, torch)
        pairs = B * hq * sum(min(i + 1, w) for i in range(S))
        stats = 2 * 4 * B * hq * S
        note = (f"(a model-4 rank: BH={B * hq}, KV heads {hkv}, D={D}, "
                f"causal, window {w}, bf16; plain: dq, dk and dv in one "
                "call; library: one SDPA backward)")
        self.report(f"tp rank B={B} S={S}", "flash_dq", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:124",
                    dq_dev, dq_wall, p_dev, p_wall,
                    item * B * S * D * (3 * hq + 2 * hkv) + stats,
                    6 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        self.report(f"tp rank B={B} S={S}", "flash_dkv", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:159",
                    dkv_dev, dkv_wall, p_dev, p_wall,
                    item * B * S * D * (2 * hq + 4 * hkv) + stats,
                    8 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        del q, k, v, o, lse, do, views, call, flat
        torch.cuda.empty_cache()

    def tp_moe_kernels(self):
        """The flash kernels at granite's model-4 rank shapes (4 q heads, 2
        KV heads, D 64: the D-64 instantiations; the MoE step runs the
        float32 ones)."""
        self.tp_flash_bwd("granite", 4, 2, 64)
        self.tp_flash_fwd("granite", 4, 2, 64)

    def tp_mla_kernels(self):
        """The flash kernels at minicpm3's model-4 rank shapes (10 of 40 q
        heads, KV 10, D 96: the D-128 instantiations; the MLA step runs the
        float32 ones)."""
        self.tp_flash_bwd("minicpm3", 10, 10, 96)
        self.tp_flash_fwd("minicpm3", 10, 10, 96)

    def tp_flash_bwd(self, who, hq, hkv, D):
        """The flash backward pair at ``who``'s model-4 rank shape of the
        step (B 2, S 4,096; ``hq`` q heads, ``hkv`` KV heads, head dim
        ``D``, causal, no window): held to the plain backward in bf16 and
        float32 as *flash_bwd* holds it, two launches bit-equal; then in
        bf16 timed beside the plain backward and one SDPA backward."""
        torch, Fa = self.torch, self.Fa
        item = 2
        B, S = TP_B // TP_MESH[0], TRAIN_S
        saved = (Fa.flash_fwd.launches, Fa.flash_bwd.launches_dq,
                 Fa.flash_bwd.launches_dkv)
        msgs = []
        for dtype in FLASH_TOL:
            q, k, v, o, lse, do = self.bwd_inputs(B, hq, hkv, S, D, dtype, 0)
            flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                    for x in (q, k, v, o, do)]
            want = Fa.attention_bwd_ref(*flat[:4], lse.reshape(-1, S),
                                        flat[4], window=0)
            views = [x.transpose(1, 2) for x in (q, k, v, o, do)]
            got = Fa.flash_bwd(*views[:4], lse, views[4], window=0)
            again = Fa.flash_bwd(*views[:4], lse, views[4], window=0)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("tp", f"flash backward at {who}'s rank shape, {dtype}: "
                           "two launches give different bits")
            ok, (eq, ekv), msg = self.bwd_close(
                [x.reshape(-1, S, D) for x in got], want, dtype)
            self.max_err["flash_dq"] = max(self.max_err["flash_dq"], eq)
            self.max_err["flash_dkv"] = max(self.max_err["flash_dkv"], ekv)
            if not ok:
                fail("tp", f"flash backward at {who}'s rank shape (B {B}, "
                           f"heads {hq}/{hkv}, S {S}, D {D}), {dtype}: {msg}"
                           " against the plain backward")
            msgs.append(f"{dtype} {msg}")
            del q, k, v, o, lse, do, flat, want, views, got, again
        Fa.flash_fwd.launches, Fa.flash_bwd.launches_dq, \
            Fa.flash_bwd.launches_dkv = saved
        inst = 64 if D <= 64 else 128
        say("tp", f"flash backward (D-{inst} kernels) at {who}'s model-4 "
                  f"rank shape (B {B}, heads {hq}/{hkv}, S {S}, D {D}, "
                  f"causal) against the plain backward: max abs err "
                  f"{'; '.join(msgs)} (row tolerance {ROW_TOL}, float32 "
                  f"also allclose {REF_GRAD_TOL}); two launches bit-equal; "
                  f"card {self.card}")
        q, k, v, o, lse, do = self.bwd_inputs(B, hq, hkv, S, D, "bfloat16",
                                              0)
        views = [x.transpose(1, 2) for x in (q, k, v, o, do)]
        call = Fa.BwdCall(*views[:4], lse, views[4], window=0, causal=True)
        dq_dev, dq_wall = timed(call.dq, 10, torch)
        dkv_dev, dkv_wall = timed(call.dkv, 10, torch)
        Fa.flash_fwd.launches, Fa.flash_bwd.launches_dq, \
            Fa.flash_bwd.launches_dkv = saved
        lib = self.sdpa_bwd_ms(q, k, v, do)
        flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                for x in (q, k, v, o, do)]
        p_dev, p_wall = timed(lambda: Fa.attention_bwd_ref(
            *flat[:4], lse.reshape(-1, S), flat[4], window=0), 1, torch)
        pairs = B * hq * S * (S + 1) // 2
        stats = 2 * 4 * B * hq * S
        note = (f"({who}'s model-4 rank: BH={B * hq}, KV heads {hkv}, "
                f"D={D}, causal, bf16; plain: dq, dk and dv in one call; "
                "library: one SDPA backward)")
        self.report(f"tp rank {who} B={B} S={S}", "flash_dq",
                    "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:124",
                    dq_dev, dq_wall, p_dev, p_wall,
                    item * B * S * D * (3 * hq + 2 * hkv) + stats,
                    6 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        self.report(f"tp rank {who} B={B} S={S}", "flash_dkv",
                    "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:159",
                    dkv_dev, dkv_wall, p_dev, p_wall,
                    item * B * S * D * (2 * hq + 4 * hkv) + stats,
                    8 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        del q, k, v, o, lse, do, views, call, flat
        torch.cuda.empty_cache()

    def tp_flash_fwd(self, who, hq, hkv, D):
        """The flash forward at ``who``'s model-4 rank shape of the prefill
        (1 x PREFILL_S; ``hq`` q heads, ``hkv`` KV heads, head dim ``D``,
        causal, no window, bf16): held to the chunked plain attention and
        lse in float32 on the same values as the flash phase holds
        danube's main shape, then timed beside one call of the chunked
        plain version and one causal SDPA call, with its bound."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import (flash_or_ref,
                                                  ref_attention_chunked)
        item, Sp = 2, PREFILL_S
        q, k, v = self.attn_inputs(1, hq, hkv, Sp, D, "bfloat16")
        views = [x.transpose(1, 2) for x in (q, k, v)]
        saved = Fa.flash_fwd.launches
        k_dev, k_wall = timed(lambda: Fa.flash_fwd(*views), 10, torch)
        o, lse = Fa.flash_fwd(*views)
        Fa.flash_fwd.launches = saved
        pos = torch.arange(Sp, device=self.dev)[None]
        kf = k.float()
        o_ref = ref_attention_chunked(q.float(), kf, v.float(), pos, pos)
        l_ref = chunked_lse(torch, q.float(), kf, 0, 1 / math.sqrt(D))
        ok, eo, msg = self.attn_close(o.transpose(1, 2), lse.transpose(1, 2),
                                      o_ref, l_ref, *FLASH_TOL["bfloat16"])
        self.max_err["flash_fwd"] = max(self.max_err["flash_fwd"], eo)
        name = (f"flash forward at {who}'s rank shape (heads {hq}/{hkv}, "
                f"D={D}, S={Sp}, causal, bf16)")
        if not ok:
            fail("tp", f"{name} against its plain version: {msg}")
        say("tp", f"{name} against the chunked plain version in float32: "
                  f"max abs err {msg} (tolerance o {FLASH_TOL['bfloat16'][0]}"
                  f", lse {FLASH_TOL['bfloat16'][1]}, row {ROW_TOL}, lse abs "
                  f"{LSE_ABS})")
        del o, lse, o_ref, l_ref, kf
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        flash_or_ref(q, k, v, pos, pos)
        b.record()
        torch.cuda.synchronize()
        p_ms = a.elapsed_time(b)
        lib = self.sdpa_ms(q, k, v, 0)
        self.report(f"tp rank {who} S={Sp}", "flash_fwd", "flash_fwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:44",
                    k_dev, k_wall, p_ms, p_ms,
                    item * Sp * D * (2 * hq + 2 * hkv) + 4 * hq * Sp,
                    4 * D * (Sp * (Sp + 1) // 2) * hq, 1,
                    peak=BF16_OPS_PER_S, library_ms=lib,
                    note=f"({who}'s model-4 rank: BH={hq}, KV heads {hkv}, "
                         f"D={D}, causal, no window, bf16; plain: one call "
                         "of the chunked plain version; library: "
                         "is_causal=True)")
        del q, k, v, views
        torch.cuda.empty_cache()

    # ------------------------------------- 27. launch: cells and dry-run
    def launch(self):
        """The dry-run's records and its predictions held to the card (their
        meta runs started with the run: :meth:`start_launch`)."""
        torch = self.torch
        from repro_torch.configs import registry
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
            else self.card
        print(card, flush=True)
        from repro_torch.launch.dryrun import HBM_BYTES
        total = torch.cuda.get_device_properties(0).total_memory
        if total != HBM_BYTES:
            fail("launch", f"the card reports {total:,} bytes, the dry-run "
                           f"judges fits against HBM_BYTES {HBM_BYTES:,}")
        say("launch", f"card {card}; {torch.cuda.get_device_name(0)}, "
                      f"{total:,} bytes, equal to the dry-run's HBM_BYTES")
        futs = self.launch_futs
        self.launch_prefill(futs[LAUNCH_PREDS["prefill"]])
        self.launch_train(futs[LAUNCH_PREDS["train"]])
        self.launch_decode(futs[LAUNCH_PREDS["decode"]])
        self.launch_partitioned(futs[LAUNCH_PREDS["tp"]], TP_LAUNCH)
        self.launch_partitioned(futs[LAUNCH_PREDS["tp_moe"]], TP_LAUNCH_MOE)
        self.launch_partitioned(futs[LAUNCH_PREDS["tp_hybrid"]],
                                TP_LAUNCH_HYBRID)
        self.launch_partitioned(futs[LAUNCH_PREDS["tp_mla"]], TP_LAUNCH_MLA)
        for t in LAUNCH_RECORDS:
            r = futs[t].result()
            mem = r["memory"]
            say("launch", f"dry-run {t[1]}/{t[2]}/"
                          f"{'multi' if t[3] else 'single'} {r['mesh']}: "
                          f"{mem['per_device_total'] / 2**30:.2f} GiB a "
                          f"device (argument {mem['argument'] / 2**30:.2f}, "
                          f"temp {mem['temp'] / 2**30:.2f}; fits: "
                          f"{mem['fits_h100']}), "
                          f"{r['flops_per_device'] / 1e12:.3f} TFLOP, "
                          f"t_compute {1e3 * r['t_compute']:.3f} ms, "
                          f"t_memory {1e3 * r['t_memory']:.3f} ms, "
                          f"t_collective {1e3 * r['t_collective']:.3f} ms "
                          f"({r['run_s']} s on meta)")
        n_cells = sum(1 for a, _, skip in registry.all_cells()
                      if a in LAUNCH_ARCHS and not skip)
        say("launch", f"{2 * n_cells} dry-run records and "
                      f"{len(LAUNCH_PREDS)} predictions in {LAUNCH_WORKERS} "
                      f"workers started with the run, all done "
                      f"{max(self.launch_done) - self.launch_t0:.1f} s after "
                      f"it started; constants: NVIDIA H100 80GB HBM3 spec "
                      f"sheet; card {card}")

    def start_launch(self):
        """LAUNCH_PREDS' and LAUNCH_RECORDS' meta runs, submitted in that
        order to LAUNCH_WORKERS worker processes at nice 19 when the run
        starts; each future's finishing time goes to ``launch_done``."""
        import concurrent.futures as cf
        import multiprocessing
        self.launch_pool = cf.ProcessPoolExecutor(
            LAUNCH_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=os.nice, initargs=(19,))
        self.launch_t0 = time.time()
        for t in tuple(LAUNCH_PREDS.values()) + LAUNCH_RECORDS:
            self.launch_futs[t] = self.launch_pool.submit(launch_task, t)
            self.launch_futs[t].add_done_callback(
                lambda _: self.launch_done.append(time.time()))

    def launch_run(self, cell, args, count: bool = True, lone=None):
        """``cell.fn`` on ``args`` once (under FlopCounterMode with
        ``count``; as a rank of mesh ``lone`` alone, spmd.lone_rank, when
        given): (its output, the counted flops or None, the peak bytes
        allocated over the run above what was allocated before ``args``).
        """
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.parallel import spmd
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) if count else \
                contextlib.nullcontext() as fc, \
                spmd.lone_rank(lone) if lone is not None else \
                contextlib.nullcontext():
            out = cell.fn(*args)
        torch.cuda.synchronize()
        return out, fc.get_total_flops() if count else None, \
            torch.cuda.max_memory_allocated() - self.launch_base

    def launch_hold(self, what, pred, flops, peak, band=LAUNCH_BAND):
        """The card's flop count equal to the meta count, its peak within
        ``band`` of the prediction."""
        mem = pred["memory"]
        ok, rel = memory_band(peak, mem["per_device_total"], band)
        if flops != pred["flops_per_device"] or not ok:
            fail("launch", f"{what}: {flops:.6g} flops on the card against "
                           f"{pred['flops_per_device']:.6g} on meta; peak "
                           f"{peak:,} bytes against "
                           f"{mem['per_device_total']:,} predicted "
                           f"({rel:.1%}, band {band:.0%})")
        say("launch", f"{what}: {flops / 1e12:.3f} TFLOP counted on the "
                      "card, equal to the meta count; peak "
                      f"{peak / 2**30:.3f} GiB above the memory before the "
                      f"args, predicted {mem['per_device_total'] / 2**30:.3f}"
                      f" (argument {mem['argument'] / 2**30:.3f} + output "
                      f"{mem['output'] / 2**30:.3f} - alias "
                      f"{mem['alias'] / 2**30:.3f} + temp "
                      f"{mem['temp'] / 2**30:.3f}): {rel:.1%} off (band "
                      f"{band:.0%})")
        return rel

    def launch_cell(self, arch, shape, mesh_shape, depth, fut):
        """The cell on a mesh of the card named ``mesh_shape``'s size
        times, the prediction from ``fut`` (printed), and one rank's share
        of its args materialized on the card."""
        torch = self.torch
        from repro_torch.launch.dryrun import rank_share
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.steps import build_cell, materialize
        mesh = make_mesh(mesh_shape, ("data", "model"),
                         [self.dev] * (mesh_shape[0] * mesh_shape[1]))
        cell = build_cell(arch, shape, mesh, depth_override=depth)
        # earlier phases' garbage freed first: a reference cycle collected
        # during the run would lower the peak read above this base
        gc.collect()
        torch.cuda.synchronize()
        self.launch_base = torch.cuda.memory_allocated()
        t0 = time.time()
        args = materialize(cell, rank_share(cell), self.dev, seed=0)
        torch.cuda.synchronize()
        secs = time.time() - t0
        pred = fut.result()
        mem = pred["memory"]
        say("launch", f"{arch}/{shape} on one rank of {mesh_shape}"
                      + (f", depth {depth}" if depth else "")
                      + f" (args drawn on the card in {secs:.1f} s): "
                      f"predicted {mem['per_device_total'] / 2**30:.3f} GiB "
                      f"a device, {pred['flops_per_device'] / 1e12:.3f} "
                      "TFLOP (meta), before the run")
        return cell, pred, args

    def launch_prefill(self, fut):
        from repro_torch.launch.dryrun import PEAK_FLOPS
        torch, Fa = self.torch, self.Fa
        cell, pred, args = self.launch_cell("h2o_danube_3_4b", "prefill_32k",
                                            LAUNCH_PREFILL_MESH, None, fut)
        t0 = time.time()
        plain, flops, peak = self.launch_run(cell, args)
        secs = time.time() - t0
        self.launch_hold("danube prefill_32k (plain)", pred, flops, peak)
        golden_side = ", beside the goldens' two worker processes" \
            if self.golden_futs else ""
        say("launch", f"danube prefill_32k, {tuple(args[1]['tokens'].shape)}"
                      f" tokens: {secs:.3f} s (wall, under the flop "
                      f"counter{golden_side}), {flops / secs / 1e12:.1f} "
                      f"TFLOP/s; "
                      f"t_compute {1e3 * flops / PEAK_FLOPS:.1f} ms at 989 "
                      f"TFLOP/s ({flops / PEAK_FLOPS / secs:.1%} of it)")
        cell.model.use_flash = True
        Fa.flash_fwd.launches = 0
        try:
            flash = cell.fn(*args)
            torch.cuda.synchronize()
        finally:
            cell.model.use_flash = False
        n = Fa.flash_fwd.launches
        gap = logit_gap(flash.float(), plain.float())
        if n != cell.model.cfg.num_layers or not torch.allclose(
                flash.float(), plain.float(), atol=MODEL_ATOL,
                rtol=MODEL_RTOL):
            fail("launch", f"flash route: {n} launches, last-token logits "
                           f"against the plain route: {gap}")
        say("launch", f"danube prefill_32k through use_flash: {n} flash "
                      f"launches, last-token logits against the plain route "
                      f"(atol {MODEL_ATOL}, rtol {MODEL_RTOL}): {gap}; card "
                      f"{self.card}")
        del args, plain, flash

    def launch_train(self, fut):
        torch = self.torch
        cell, pred, args = self.launch_cell("h2o_danube_3_4b", "train_4k",
                                            (16, 1), 2, fut)
        from repro_torch.launch.steps import make_train_config
        params, opt, batch = args
        # the step at the end of the warm-up, where the learning rate peaks
        # (it is 0 at step 0; a bf16 weight moves when its update passes
        # half its ulp)
        opt.step.fill_(make_train_config(cell.arch, cell.shape).warmup_steps)
        leaves = [t for _, t in _tree_items(params)]
        before = [t.to("cpu", copy=True) for t in leaves]
        # the peak is read without the flop counter: under it the backward
        # (on the autograd engine's device thread) held 5.6 GiB more on an
        # H100 (chip_memory.py), forward-only cells the same
        (params, opt, metrics), _, peak = self.launch_run(cell, args,
                                                          count=False)
        loss = metrics["loss"].item()
        moved = sum(not torch.equal(b, t.to("cpu"))
                    for b, t in zip(before, leaves))
        if not math.isfinite(loss) or moved != len(leaves):
            fail("launch", f"train step: loss {loss}, {moved} of "
                           f"{len(leaves)} parameters moved")
        _, flops, _ = self.launch_run(cell, args)      # a second step
        self.launch_hold(f"danube train_4k depth 2, "
                         f"{tuple(batch['tokens'].shape)} tokens, "
                         f"accum {cell.accum}", pred, flops, peak)
        say("launch", f"train step: loss {loss:.4f}, all {moved} parameter "
                      f"tensors moved, lr {metrics['lr'].item():.3g} (the "
                      "flops from a second step); card "
                      f"{self.card}")
        del args, params, opt, batch, before, leaves

    def launch_partitioned(self, fut, which):
        """A partitioned record (``which``: TP_LAUNCH, TP_LAUNCH_MOE,
        TP_LAUNCH_HYBRID, TP_LAUNCH_MLA): one rank's program alone on the
        card, on its
        blocks of the args, against the meta prediction (flops equal, peak
        within TP_LAUNCH_BAND)."""
        torch = self.torch
        from repro_torch.launch.steps import make_train_config
        arch, shape, mesh_shape, depth = which
        cell, pred, args = self.launch_cell(arch, shape, mesh_shape, depth,
                                            fut)
        mesh = cell.model.mesh
        if not cell.partitioned or \
                pred["memory"]["temp_at_full_model_width"]:
            fail("launch", f"{arch}/{shape} on {mesh_shape} is not "
                           "partitioned")
        params, opt, batch = args
        opt.step.fill_(make_train_config(cell.arch, cell.shape).warmup_steps)
        mixer = params["blocks"]["0"].get("attn") or \
            params["blocks"]["0"]["ssm"]
        leaf = next(k for k in ("wq", "wq_a", "wz") if k in mixer)
        wq = mixer[leaf]
        (params, opt, metrics), _, peak = self.launch_run(
            cell, args, count=False, lone=mesh)
        loss = metrics["loss"].item()
        if not math.isfinite(loss):
            fail("launch", f"partitioned train step: loss {loss}")
        _, flops, _ = self.launch_run(cell, args, lone=mesh)
        rel = self.launch_hold(
            f"{arch} {shape} depth {depth}, one rank of {mesh_shape} alone "
            f"(its blocks: layer 0's {leaf} {tuple(wq.shape)}, tokens "
            f"{tuple(batch['tokens'].shape)}, accum {cell.accum})", pred,
            flops, peak, band=TP_LAUNCH_BAND)
        self.rates[("tp", "launch", arch)] = (rel, peak, pred)
        from repro_torch.launch.dryrun import by_axes
        say("launch", f"partitioned train step: loss {loss:.4f}, lr "
                      f"{metrics['lr'].item():.3g}; the rank's recorded "
                      f"collectives {by_axes(pred['recorded'])}; card "
                      f"{self.card}")
        del args, params, opt, batch, wq

    def launch_decode(self, fut):
        torch = self.torch
        cell, pred, args = self.launch_cell("mamba2_130m", "decode_32k",
                                            (1, 1), None, fut)
        cache = args[1]
        ptrs = [t.data_ptr() for _, t in _tree_items(cache)]
        (logits, out), flops, peak = self.launch_run(cell, args)
        in_place = out is cache and ptrs == [
            t.data_ptr() for _, t in _tree_items(out)]
        written = all(bool(c.state.abs().sum() > 0) for c in out)
        if not bool(torch.isfinite(logits).all()) or not in_place or \
                not written:
            fail("launch", f"decode: logits finite "
                           f"{bool(torch.isfinite(logits).all())}, cache "
                           f"in place {in_place}, every state written "
                           f"{written}")
        rel = self.launch_hold(f"mamba2 decode_32k, batch "
                               f"{args[2].shape[0]}", pred, flops, peak)
        cache_bytes = sum(t.numel() * t.element_size()
                          for _, t in _tree_items(cache))
        caught = []
        for fault in LAUNCH_FAULTS:
            total = planted_memory(pred["memory"], fault, cache_bytes)
            ok, frel = memory_band(peak, total)
            if ok:
                fail("launch", f"planted fault {fault!r} ({total:,} bytes "
                               f"predicted) passes the band: {frel:.1%}")
            caught.append(f"{fault} {frel:.1%} off")
        say("launch", f"decode: logits {tuple(logits.shape)} finite, the "
                      f"cache ({cache_bytes / 2**30:.3f} GiB) written in "
                      f"place; the true prediction {rel:.1%} off, planted "
                      f"faults fail the band: {'; '.join(caught)}")
        del args, cache, logits, out

    # --------------------------------------- 29. 512 hosts, 8 lanes, tiled
    def grid512(self):
        torch, T, Tl, Wn, Rf = self.torch, self.T, self.Tl, self.Wn, self.Rf
        from repro_torch.kernels.netsim_tick import ops
        topo, wl, cfg = multipod(T, 16, 1000)
        knobs = T.stack_knobs([cfg.knobs(), cfg._replace(sym_on=True).knobs()])
        seeds = [0, 1, 2, 3]

        def run(**kw):
            torch.cuda.synchronize()
            t0 = time.time()
            res = T.simulate_grid(topo, wl, cfg._replace(**kw).structure(),
                                  knobs, seeds=seeds, routing="ecmp",
                                  device=self.dev)
            torch.cuda.synchronize()
            return res, cfg.n_ticks / (time.time() - t0)

        eager, eager_rate = run()
        tiled_kw = dict(backend="cuda", segsum="onehot", blk=BLK["multipod512"])
        Tl.netsim_tiled.launches = 0                 # main path starts
        tiled, rate1 = run(**tiled_kw)
        n_tiled = Tl.netsim_tiled.launches           # main path ends
        Wn.netsim_window.launches = 0                # main path starts
        win, rate20 = run(backend="cuda", tick_window=20)
        n_win = Wn.netsim_window.launches            # main path ends
        if n_tiled != cfg.n_ticks or n_win != cfg.n_ticks // 20:
            fail("grid512", f"{n_tiled} tiled and {n_win} window launches "
                            f"for {cfg.n_ticks} ticks")
        self.launches["netsim_tiled"] = n_tiled
        self.rates[("multipod512", 1)] = rate1
        self.rates[("multipod512", 20)] = rate20
        # the tiled tick's plain version on the card, through the same path
        saved = ops.netsim_tiled
        ops.netsim_tiled = Rf.tiled_tick_ref
        try:
            plain, _ = run(**tiled_kw)
        finally:
            ops.netsim_tiled = saved
        R = cfg.record_every
        for name, x, ref in (("tiled vs its plain version", tiled, plain),
                             ("tick_window=20 vs eager", win, eager)):
            for f in T.SimResult._fields:
                a, b = getattr(x, f), getattr(ref, f)
                if f in INT_SERIES:
                    if not torch.equal(a, b):
                        fail("grid512", f"{name}: {f} differs")
                else:
                    self.compare("grid512", f"{name}: {f}", a, b,
                                 rtol=RTOL_TPUT if f == "ts_throughput"
                                 else RTOL)
                    if x is tiled and self.bits_differ(a, b):
                        fail("grid512", f"{name}: {f} differs in its bits")
        # the tiled tick against eager: onehot's contract is allclose on
        # floats, so integer series may part; count where and report
        diffs, first = 0, None
        for f in INT_SERIES:
            d = getattr(tiled, f) != getattr(eager, f)
            diffs += int(d.sum())
            if f.startswith("ts_") and d.any():
                # [K, S, T, ...] -> the first record period that differs
                t = int(torch.nonzero(d.transpose(0, 2).reshape(
                    d.shape[2], -1).any(1))[0])
                tick = (t + 1) * R - 1
                first = tick if first is None else min(first, tick)
        err = (tiled.ts_throughput - eager.ts_throughput).abs().max().item()
        done = win.ts_done_min[:, :, -1, 0].flatten().tolist()
        wire = win.ts_max_wire[:, :, -1, 0].flatten().tolist()
        say("grid512", f"8 lanes x {cfg.n_ticks} ticks at 512 hosts: tiled "
                       f"(blk={BLK['multipod512']}) == its plain version bit "
                       f"for bit on every series ({n_tiled} tiled launches, "
                       f"{rate1:.1f} ticks/s); tick_window=20 == eager "
                       f"({n_win} window launches, {rate20:.1f} ticks/s); "
                       f"eager {eager_rate:.1f} ticks/s; steps done per lane"
                       f" {done}, newest wire step {wire}")
        say("grid512", f"tiled vs eager: {diffs} integer entries differ"
                       + (f", first at tick {first}" if first is not None
                          else "") + f"; throughput max abs diff {err}")

    # ------------------------------------------------------- 30. control
    def control(self):
        torch, T, Wn = self.torch, self.T, self.Wn
        topo, wl, cfg = table1(T)
        cfg = cfg._replace(n_ticks=3200, sym_on=True, backend="cuda",
                           tick_window=20)
        one = T.simulate(topo, wl, cfg, routing="ecmp", seed=3,
                         device=self.dev)
        ctl = T.SimController(topo, wl, cfg, window_ticks=640, seed=3)
        Wn.netsim_window.launches = 0
        parts = []
        for _ in range(cfg.n_ticks // 640):
            state, obs = ctl.step()
            parts.append(obs.samples)
        if Wn.netsim_window.launches != cfg.n_ticks // 20:
            fail("control", f"{Wn.netsim_window.launches} window launches "
                            f"for {cfg.n_ticks} ticks")
        if obs.tick != cfg.n_ticks or \
                not torch.equal(state.engine.finish[0], one.finish_ticks) or \
                not torch.equal(state.engine.job_finish[0],
                                one.job_finish_ticks):
            fail("control", "stepped run differs from one-shot simulate")
        for f in T.WindowSamples._fields:
            if not torch.equal(torch.cat([getattr(p, f) for p in parts]),
                               getattr(one, f)):
                fail("control", f"stepped series {f} differs from one-shot")
        say("control", f"5 steps of 640 ticks equal one-shot simulate bit "
                       f"for bit (every series); {Wn.netsim_window.launches}"
                       " window launches")
        ctl.reset()
        ctl.step()
        snap = ctl.checkpoint()
        if snap.engine.sent.device.type != "cpu":
            fail("control", "checkpoint is not a CPU copy")
        ctl.step({"tau": 0.05})
        sa, oa = ctl.step()
        ctl.restore(snap)
        if ctl.state.engine.sent.device.type != self.dev.type:
            fail("control", "restore did not move the state to the card")
        ctl.step({"tau": 0.05})
        sb, ob = ctl.step()
        if sa.tick != sb.tick or not all(
                torch.equal(x, y) for x, y in zip(sa.engine, sb.engine)):
            fail("control", "restore + replay differs")
        tuned = float(ctl.knobs.sym.tau)
        say("control", f"tau retuned to {tuned:.2f} at tick 640; rewind to "
                       f"the tick-640 checkpoint replays ticks 640-1920 bit "
                       f"for bit (alpha max {oa.stats.alpha_max:.0f}, queue "
                       f"max {oa.stats.qmax:.0f} B)")

    # -------------------------------------------------------- 31. timing
    def timing(self):
        torch, K, Rf, Wn, Tl = self.torch, self.K, self.Rf, self.Wn, self.Tl
        from repro_torch.core.netsim.stages import stage_starts
        from repro_torch.kernels.netsim_tick.ops import (tick_operands,
                                                         tiled_operands)
        for shape in ("table1", "multipod128", "multipod512"):
            big = shape == "multipod512"
            ctx, ecfg, state, tick = self.mid_state(shape, True)
            # -- single tick
            starts = stage_starts(ctx, state, tick)
            args, kw = tick_operands(ctx, ecfg, starts, state, tick)
            saved = K.netsim_tick.launches
            k_dev, k_wall = timed(lambda: K.netsim_tick(*args, **kw),
                                  5 if big else 100, torch)
            K.netsim_tick.launches = saved
            p_dev, p_wall = timed(lambda: Rf.hot_tick(*args, **kw),
                                  3 if big else 30, torch)
            out = Rf.hot_tick(*args, **kw)
            # bytes the timed mode must move: every operand it reads once
            # and every output once.  With per-step ECMP the routes come
            # from the candidate table, so the static routes (arg 10) are
            # not read.
            nbytes = tensor_bytes(a for i, a in enumerate(args)
                                  if i != 10) + tensor_bytes(out)
            B, FW = args[0].shape
            H = ctx.H
            # float operations this run's data needs: ~30 per instance
            # plus 5 adds per (instance, hop) entry of the link and
            # Symphony sums
            ops = B * FW * (30 + 5 * H)
            self.report(shape, "netsim_tick", "netsim_tick.cu",
                        "src/repro/kernels/netsim_tick/kernel.py:339",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, 1)
            # -- tiled tick
            blk = BLK[shape]
            args, kw = tiled_operands(ctx, ecfg, starts, state, tick, blk)
            saved = Tl.netsim_tiled.launches
            k_dev, k_wall = timed(lambda: Tl.netsim_tiled(*args, **kw), 20,
                                  torch)
            Tl.netsim_tiled.launches = saved
            p_dev, p_wall = timed(lambda: Rf.tiled_tick_ref(*args, **kw),
                                  3 if big else 10, torch)
            out = Rf.tiled_tick_ref(*args, **kw)
            tb = args[19]
            # per-step ECMP reads one candidate row (links and domains) of
            # every instance, its path count and one chunk size
            nbytes = (tensor_bytes(a for i, a in enumerate(args) if i != 19)
                      + 4 * B * FW * (2 * H + 2) + tensor_bytes(out))
            self.report(shape, "netsim_tiled", "netsim_tiled.cu",
                        "src/repro/kernels/netsim_tick/kernel.py:374",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, 1,
                        note=f"blk={blk}, {-(-FW // blk)} blocks")
            if "netsim_tiled" in (self.against or {}):
                self.against_turns(
                    "netsim_tiled", f"{shape} blk={blk}",
                    lambda: Tl.netsim_tiled(*args, **kw),
                    self.tiled_against_call(self.variant(
                        "netsim_tiled", "against_tiled",
                        csrc=self.against["netsim_tiled"]), args, kw),
                    5 if big else 20)
            # -- window of 20 ticks
            n = 20
            saved = Wn.netsim_window.launches
            k_dev, k_wall = timed(
                lambda: Wn.netsim_window(ctx, ecfg, state, tick, n),
                2 if big else 20, torch)
            Wn.netsim_window.launches = saved
            p_dev, p_wall = timed(
                lambda: Rf.window_ref(ctx, ecfg, state, tick, n),
                1 if big else 2, torch)
            new, smp = Rf.window_ref(ctx, ecfg, state, tick, n)
            iscal, fscal = Wn.window_operands(ctx, ecfg)
            st, wl = ctx.st, ctx.wl
            operands = (list(state) + [getattr(wl, f) for f in Wn._WL_FIELDS]
                        + [getattr(ctx, f) for f in Wn._CTX_FIELDS]
                        + [getattr(st, f) for f in Wn._STATIC_FIELDS]
                        + [iscal, fscal])
            nbytes = tensor_bytes(operands) + tensor_bytes(new) + \
                tensor_bytes(smp)
            # float operations per instance and tick: the hot stages (~30
            # + 5 per hop), marking (~12 per hop + 4), progress and DCQCN
            # (~20), the threefry draw (~90 integer operations per pair of
            # instances on a CC epoch)
            cc = int(ecfg.cc_periods[0])
            ops_w = n * B * FW * (54 + 17 * H + 45 / cc)
            self.report(shape, "netsim_window", "netsim_window.cu",
                        "src/repro/kernels/netsim_tick/window.py:64",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops_w, n)
        # -- switch pipeline: 8,000 packets, then the main path's 1,000,000
        Sp = self.Sp
        for P, seed in ((8000, 7), (1_000_000, 11)):
            trace = self.switch_trace(P, seed)
            saved = Sp.switch_pipeline.launches
            k_dev, k_wall = timed(lambda: Sp.switch_pipeline(*trace),
                                  20 if P < 10**5 else 3, torch)
            Sp.switch_pipeline.launches = saved
            # the plain version walks the state block on the host: its
            # cost is the wall time of one call
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            Sp.pipeline_plain(*trace)
            b.record()
            torch.cuda.synchronize()
            p_wall = a.elapsed_time(b)
            # 20 bytes in and 16 out per packet and the 64-byte LUT; ~20
            # float operations per packet on the exact path
            self.report(f"P={P}", "switch_pipeline", None,
                        "src/repro/kernels/switch_pipeline/kernel.py:42",
                        k_dev, k_wall, p_wall, p_wall, 36 * P + 64,
                        20 * P, 1, note="(plain version: wall time; its "
                                        "state walk runs on the host)")
            if "switch_pipeline" in (self.against or {}):
                self.against_turns(
                    "switch_pipeline", f"P={P}",
                    lambda: Sp.switch_pipeline(*trace),
                    self.switch_against_call(self.variant(
                        "switch_pipeline", "against_switch",
                        csrc=self.against["switch_pipeline"]), trace),
                    20 if P < 10**5 else 3)
        self.timing_flash()
        self.timing_family_flash()
        self.timing_flash_bwd()
        self.timing_ssd()
        self.timing_ssd(JAMBA_SSD, "jamba")

    def against_turns(self, lib, what, shipped, theirs, n):
        """Another commit's kernel (``theirs``) timed in turns with the
        shipped one (against, shipped, shipped, against) on the same
        inputs; their outputs must agree bit for bit."""
        torch = self.torch
        counter = self.Tl.netsim_tiled if lib == "netsim_tiled" \
            else self.Sp.switch_pipeline
        saved = counter.launches
        ms = [timed(f, n, torch)[0] for f in (theirs, shipped, shipped,
                                               theirs)]
        a, b = theirs(), shipped()
        counter.launches = saved
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                fail("timing", f"{lib} {what}: the --against kernel's "
                               "outputs differ from the shipped one's")
        say("timing", f"{lib} {what} against {self.against[lib]}: "
                      f"{ms[0]:.4f} / {ms[3]:.4f} ms a launch beside the "
                      f"shipped kernel's {ms[1]:.4f} / {ms[2]:.4f} ms "
                      f"(against, shipped, shipped, against; "
                      f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x), outputs "
                      f"equal bit for bit, card {self.card}")

    def tiled_against_call(self, lib, args, kw):
        """A function that runs library ``lib``'s tiled tick (another
        commit's) on these operands, through the interface its
        ``netsim_tiled_abi()`` names: none exported, the first port's (the
        shipped wrapper's 50 pointers begin with its 45; its own
        shared-memory formula); ``tiled.ABI``, the shipped one.  Fails on
        any other."""
        from repro_torch.kernels import _build
        Tl = self.Tl
        abi = lib.netsim_tiled_abi() if hasattr(lib, "netsim_tiled_abi") \
            else 1
        if abi == Tl.ABI:
            def call():
                with self.using("netsim_tiled", lib):
                    return Tl.netsim_tiled(*args, **kw)
            return call
        if abi != 1:
            fail("timing", f"--against: netsim_tiled_abi() is {abi}; this "
                           f"script calls interfaces 1 and {Tl.ABI}")
        p = ctypes.c_void_p
        lib.netsim_tiled_launch.argtypes = [p] * 4
        lib.netsim_tiled_launch.restype = ctypes.c_int
        lib.netsim_tiled_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.netsim_tiled_smem_bytes.restype = ctypes.c_size_t

        def call():
            own, formula = _build.build("netsim_tiled")[0], \
                Tl.tiled_smem_bytes
            _build._loaded["netsim_tiled"] = lib
            Tl.tiled_smem_bytes = lib.netsim_tiled_smem_bytes
            try:
                return Tl.netsim_tiled(*args, **kw)
            finally:
                _build._loaded["netsim_tiled"] = own
                Tl.tiled_smem_bytes = formula
        return call

    def switch_against_call(self, lib, trace):
        """A function that runs library ``lib``'s switch pipeline (another
        commit's) on ``trace``, through the interface its
        ``switch_pipeline_abi()`` names: none exported, the first port's
        one-thread walk (``switch_pipeline_launch`` without a workspace);
        ``kernel.ABI``, the shipped one.  Fails on any other."""
        torch, Sp = self.torch, self.Sp
        abi = lib.switch_pipeline_abi() \
            if hasattr(lib, "switch_pipeline_abi") else 1
        if abi == Sp.kernel.ABI:
            def call():
                with self.using("switch_pipeline", lib):
                    return Sp.switch_pipeline(*trace)
            return call
        if abi != 1:
            fail("timing", f"--against: switch_pipeline_abi() is {abi}; "
                           f"this script calls interfaces 1 and "
                           f"{Sp.kernel.ABI}")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.switch_pipeline_launch.argtypes = [p] * 9 + [i] + [f] * 5 + [i, p]
        lib.switch_pipeline_launch.restype = ctypes.c_int
        P = trace[0].numel()
        out = [torch.empty(P, dtype=dt, device=trace[0].device)
               for dt in (torch.int32, torch.int32, torch.float32,
                          torch.float32)]

        def call():
            # the wrapper's defaults: k, tau, n_warmup, n_sample, alpha_max
            rc = lib.switch_pipeline_launch(
                *(x.data_ptr() for x in (*trace, *out)), P, 0.01, 0.25,
                16.0, 32.0, 64.0, 1, torch.cuda.current_stream().cuda_stream)
            if rc:
                fail("timing", f"the --against switch kernel failed to "
                               f"launch: {rc}")
            return out
        return call

    def timing_flash(self):
        """The flash forward at the training shape (B 2, S 4,096, causal,
        danube's window, which has no bite there) beside its plain version
        and one causal scaled_dot_product_attention call, then at the main
        path's shape (B 1, S 32,768, window 8,192) beside one masked
        scaled_dot_product_attention call (the plain version's [BH, S, S]
        scores do not fit there: its time at the training shape stands in).
        Danube's heads (32/8, D 120), bf16, strided [B, S, H, D] views."""
        torch, Fa = self.torch, self.Fa
        hq, hkv, D, w = 32, 8, 120, 8192
        item = 2
        for shape, B, S in ((f"B={TRAIN_B} S={TRAIN_S}", TRAIN_B, TRAIN_S),
                            (f"S={PREFILL_S}", 1, PREFILL_S)):
            q, k, v = self.attn_inputs(B, hq, hkv, S, D, "bfloat16")
            views = [x.transpose(1, 2) for x in (q, k, v)]
            saved = Fa.flash_fwd.launches
            k_dev, k_wall = timed(lambda: Fa.flash_fwd(*views, window=w),
                                  10 if S == PREFILL_S else 30, torch)
            Fa.flash_fwd.launches = saved
            if S == PREFILL_S:
                p_dev, p_wall = self.plain_flash_ms
                lib = self.sdpa_ms(q, k, v, w)
                note = (f"(BH=32, KV heads 8, D=120, window {w}, bf16; plain "
                        f"version timed at B={TRAIN_B} S={TRAIN_S}; library: "
                        "window mask)")
            else:
                flat = [x.reshape(-1, S, D).contiguous() for x in views]
                p_dev, p_wall = timed(
                    lambda: Fa.attention_ref(*flat, window=w), 3, torch)
                self.plain_flash_ms = p_dev, p_wall
                lib = self.sdpa_ms(q, k, v, 0)
                note = (f"(BH={B * hq}, KV heads {hkv}, D=120, causal, window "
                        f"{w}, bf16; library: is_causal=True)")
                del flat
            # q, k, v and o once each, and lse; 4 D flops per visible pair
            nbytes = B * (item * S * D * (2 * hq + 2 * hkv) + 4 * hq * S)
            pairs = sum(min(i + 1, w) for i in range(S))
            ops = 4 * D * pairs * hq * B
            self.report(shape, "flash_fwd", "flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:44",
                        k_dev, k_wall, p_dev, p_wall, nbytes, ops, 1,
                        peak=BF16_OPS_PER_S, library_ms=lib, note=note)
            say("timing", f"flash forward {shape}: {k_dev:.4f} ms against "
                          f"one scaled_dot_product_attention {lib:.4f} ms: "
                          f"{k_dev / lib:.2f}x its time; card {self.card}")
            del q, k, v, views

    def timing_family_flash(self):
        """The flash forward at the families' prefill shapes (causal, no
        window, bf16, strided [B, H, S, D] views of [B, S, H, D]
        activations): granite's (B 8, heads 16/8, D 64), jamba's (B 1,
        heads 32/8, D 128), minicpm3's (B 1, heads 40/40, D 96) and
        qwen2-vl's (B 1, heads 12/2, D 128) at S 32,768, and whisper's
        teacher-forced decoder (B 16, heads 20/20, D 64, S 384), beside one
        causal scaled_dot_product_attention call and one call of the plain
        version (chunked past 2,048 rows; CUDA events around that call
        alone)."""
        torch, Fa = self.torch, self.Fa
        from repro_torch.models.attention import flash_or_ref
        fam = [(FAMILY_FLASH[p][0],) + FAMILY_FLASH[p][1:4] + (
            FAMILY_FLASH[p][5], PREFILL_S if p != "whisper" else WHISPER_S)
            for p in ("mla", "vlm", "whisper")]
        for model, B, hq, hkv, D, S in [("granite", MOE_B, 16, 8, 64,
                                         PREFILL_S),
                                        ("jamba", 1, 32, 8, 128,
                                         PREFILL_S)] + fam:
            q, k, v = self.attn_inputs(B, hq, hkv, S, D, "bfloat16")
            views = [x.transpose(1, 2) for x in (q, k, v)]
            saved = Fa.flash_fwd.launches
            k_dev, k_wall = timed(lambda: Fa.flash_fwd(*views),
                                  10 if S == PREFILL_S else 50, torch)
            Fa.flash_fwd.launches = saved
            pos = torch.arange(S, device=self.dev)[None].expand(B, S)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            flash_or_ref(q, k, v, pos, pos)
            b.record()
            torch.cuda.synchronize()
            p_ms = a.elapsed_time(b)
            lib = self.sdpa_ms(q, k, v, 0)
            nbytes = B * (2 * S * D * (2 * hq + 2 * hkv) + 4 * hq * S)
            ops = 4 * D * (S * (S + 1) // 2) * hq * B
            self.report(f"{model} B={B} S={S}", "flash_fwd", "flash_fwd.cu",
                        "src/repro/kernels/flash_attention/kernel.py:44",
                        k_dev, k_wall, p_ms, p_ms, nbytes, ops, 1,
                        peak=BF16_OPS_PER_S, library_ms=lib,
                        note=f"(BH={B * hq}, KV heads {hkv}, D={D}, causal, "
                             "no window, bf16; plain: one call of the plain "
                             "version; library: is_causal=True)")
            say("timing", f"flash forward, {model}'s prefill B={B} S={S} "
                          f"D={D}: {k_dev:.4f} ms against one "
                          f"scaled_dot_product_attention {lib:.4f} ms: "
                          f"{k_dev / lib:.2f}x its time; card {self.card}")
            del q, k, v, views

    def timing_flash_bwd(self):
        """The backward kernels at the training shape (B 2, heads 32/8, S
        4,096, D 120, danube's window, bf16, strided [B, S, H, D] views),
        each launched alone; the plain backward (dq, dk and dv in one call)
        at the same shape, or at B 1 when it does not fit; and the backward
        of one scaled_dot_product_attention call."""
        torch, Fa = self.torch, self.Fa
        hq, hkv, S, D, w = 32, 8, TRAIN_S, 120, BWD_WINDOWS[0]
        B, item = TRAIN_B, 2
        q, k, v, o, lse, do = self.bwd_inputs(B, hq, hkv, S, D, "bfloat16",
                                              w)
        views = [x.transpose(1, 2) for x in (q, k, v, o, do)]
        call = Fa.BwdCall(*views[:4], lse, views[4], window=w, causal=True)
        saved = (Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv)
        dq_dev, dq_wall = timed(call.dq, 10, torch)
        dkv_dev, dkv_wall = timed(call.dkv, 10, torch)
        Fa.flash_bwd.launches_dq, Fa.flash_bwd.launches_dkv = saved
        lib = self.sdpa_bwd_ms(q, k, v, do)
        plain_b = B
        try:
            flat = [x.transpose(1, 2).reshape(-1, S, D).contiguous()
                    for x in (q, k, v, o, do)]
            p_dev, p_wall = timed(lambda: Fa.attention_bwd_ref(
                *flat[:4], lse.reshape(-1, S), flat[4], window=w), 1, torch)
        except torch.OutOfMemoryError:
            plain_b = 1
            torch.cuda.empty_cache()
            flat = [x[:1].transpose(1, 2).reshape(-1, S, D).contiguous()
                    for x in (q, k, v, o, do)]
            p_dev, p_wall = timed(lambda: Fa.attention_bwd_ref(
                *flat[:4], lse[:1].reshape(-1, S), flat[4], window=w), 1,
                torch)
        del flat
        # visible (query, key) pairs of every head; bytes: q, k, v, dO,
        # lse and delta read once, the outputs written once
        pairs = B * hq * sum(min(i + 1, w) for i in range(S))
        stats = 2 * 4 * B * hq * S
        note = (f"(BH={B * hq}, KV heads {hkv}, D={D}, causal, window {w}, "
                f"bf16; plain: dq, dk and dv in one call at B={plain_b}; "
                "library: the backward of one scaled_dot_product_attention "
                "call)")
        self.report(f"B={B} S={S}", "flash_dq", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:124",
                    dq_dev, dq_wall, p_dev, p_wall,
                    item * B * S * D * (3 * hq + 2 * hkv) + stats,
                    6 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        self.report(f"B={B} S={S}", "flash_dkv", "flash_bwd.cu",
                    "src/repro/kernels/flash_attention/kernel.py:159",
                    dkv_dev, dkv_wall, p_dev, p_wall,
                    item * B * S * D * (2 * hq + 4 * hkv) + stats,
                    8 * D * pairs, 1, note=note, peak=BF16_OPS_PER_S,
                    library_ms=lib)
        say("timing", f"flash backward pair (dq + dk/dv) {dq_dev + dkv_dev:.4f}"
                      f" ms against one scaled_dot_product_attention "
                      f"backward {lib:.4f} ms: {(dq_dev + dkv_dev) / lib:.2f}x "
                      f"its time; card {self.card}")
        del q, k, v, o, lse, do, views, call
        if "train" in self.rates:
            tps, ms, peak = self.rates["train"]
            say("timing", f"training (phase train, host clock): {ms:.1f} ms"
                          f" a step of {TRAIN_B} x {TRAIN_S} tokens, "
                          f"{tps:,.0f} tokens/s, peak memory "
                          f"{peak / 2**30:.2f} GiB; card {self.card}")

    def timing_ssd(self, shape=SSD_MAIN, model="mamba2", phase=None):
        """The SSD kernels at a prefill's shape (the main path's, SSD_MAIN,
        by default; jamba's too), B/C bf16, strided [B, H, S, P] views of
        [B, S, H, P] as ops.ssd passes them, and its plain version on
        [B*H, S, P] copies; with ``phase`` the kernels' y and final state
        held to the plain version's (:meth:`ssd_close`), failing that
        phase; with ``--against`` the ssd.cu of another commit timed
        beside them at the main shape (:meth:`ssd_against`).  No single
        PyTorch call computes the scan: no library time."""
        torch, Sd = self.torch, self.Sd
        B, S, H, P, N, Q = shape
        x, a, Bm, Cm = self.ssd_case(B, S, H, P, N, "bfloat16")
        xv, av = x.transpose(1, 2), a.transpose(1, 2)

        def kernel():
            return Sd.ssd_chunked(xv, av, Bm, Cm, chunk=Q, n_heads=H)

        saved = Sd.ssd_chunked.launches
        k_dev, k_wall = timed(kernel, 5, torch)
        got = kernel() if phase else None
        Sd.ssd_chunked.launches = saved
        xf = xv.reshape(B * H, S, P).contiguous()
        af = av.reshape(B * H, S).contiguous()

        def plain():
            return Sd.ssd_chunked_ref(xf, af, Bm, Cm, chunk=Q, n_heads=H)

        p_dev, p_wall = timed(plain, 1, torch)
        if phase:
            y, fs = got
            ok, err, msg = self.ssd_close(
                (y.reshape(B * H, S, P), fs.reshape(B * H, N, P)), plain())
            self.max_err["ssd"] = max(self.max_err["ssd"], err)
            if not ok:
                fail(phase, f"ssd at {model}'s shape (B={B} S={S} H={H} "
                            f"P={P} N={N}) against its plain version: {msg}")
            say(phase, f"ssd at {model}'s shape (B={B} S={S} H={H} P={P} "
                       f"N={N} chunk {Q}, B/C bf16) against its plain "
                       f"version: max abs err {msg} (tolerance {SSD_TOL})")
            del got, y, fs
        del xf, af
        # x, a, B and C read once, y and the final state written once.
        # What the function needs: C B^T once per (row, chunk), it and
        # (G * L) x over the causal triangle only, C state from the second
        # chunk on (the entering state is 0), the state update every chunk.
        nbytes = 4 * B * S * H * (2 * P + 1) + 2 * 2 * B * S * N + \
            4 * B * H * N * P
        nc = S // Q
        tri = Q * (Q + 1) // 2
        ops = B * nc * 2 * tri * N + B * H * (
            nc * (2 * tri * P + 2 * Q * N * P) + (nc - 1) * 2 * Q * N * P)
        # The same products on the tensor cores in TF32, counted once per
        # split pass: C B^T 1 (bf16 B and C are exact in TF32), (G * L) x
        # 3, C state and B^T (d x) 2 each.
        ops_tc = B * nc * 2 * tri * N + B * H * (
            nc * (3 * 2 * tri * P + 2 * 2 * Q * N * P) +
            (nc - 1) * 2 * 2 * Q * N * P)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f32_ms = ops / F32_OPS_PER_S * 1e3
        label = f"B={B} S={S}" if shape == SSD_MAIN else \
            f"{model} B={B} S={S}"
        self.report(label, "ssd", "ssd.cu",
                    "src/repro/kernels/ssd/kernel.py:24", k_dev, k_wall,
                    p_dev, p_wall, nbytes, ops_tc, 1,
                    note=f"(H={H}, P={P}, N={N}, chunk {Q}, B/C bf16; four "
                         "launches a call; bound counts C B^T once per row "
                         "and the causal triangle, on the tensor cores in "
                         "TF32 once per split pass; the same products in "
                         f"float32 on the CUDA cores, {ops:.0f} ops, would "
                         f"take {f32_ms:.6f} ms, bound "
                         f"{max(bytes_ms, f32_ms):.6f} ms)",
                    peak=TF32_OPS_PER_S)
        if "ssd" in (self.against or {}) and shape == SSD_MAIN:
            self.ssd_against(xv, av, Bm, Cm)
        del x, a, Bm, Cm, xv, av

    def ssd_against(self, xv, av, Bm, Cm):
        """The SSD scan of another commit (``--against``), built as a
        variant (:meth:`variant`) and timed in turns with the shipped kernels (against, shipped, shipped,
        against) on the same inputs; its y and final state held to the
        shipped kernels' at SSD_TOL."""
        torch, Sd = self.torch, self.Sd
        src = self.against["ssd"] / "ssd.cu"
        against = self.ssd_against_call(
            self.variant("ssd", "against_ssd", csrc=self.against["ssd"]),
            xv, av, Bm, Cm)
        H, Q = xv.shape[1], SSD_MAIN[5]

        def shipped():
            return Sd.ssd_chunked(xv, av, Bm, Cm, chunk=Q, n_heads=H)

        saved = Sd.ssd_chunked.launches
        ms = [timed(f, 5, self.torch)[0]
              for f in (against, shipped, shipped, against)]
        theirs = against()
        got = shipped()
        Sd.ssd_chunked.launches = saved
        torch.cuda.synchronize()
        ok, err, msg = self.ssd_close(theirs, got)
        if not ok:
            fail("timing", f"the --against kernel differs from the shipped "
                           f"ones: {msg}")
        ratio = (ms[0] + ms[3]) / (ms[1] + ms[2])
        say("timing", f"ssd against {src}: {ms[0]:.4f} / "
                      f"{ms[3]:.4f} ms a launch beside the shipped kernels' "
                      f"{ms[1]:.4f} / {ms[2]:.4f} ms (against, shipped, "
                      f"shipped, against; {ratio:.2f}x), outputs agree "
                      f"({msg}), card {self.card}")

    def ssd_against_call(self, lib, xv, av, Bm, Cm):
        """A function that runs library ``lib``'s SSD scan on these inputs
        (B/C bf16) and returns (y, final state), through the interface that
        its ``ssd_abi()`` names: none exported, the first SSD port's single
        launch ``ssd_launch(x, a, B, C, y, state, dims, bc_dtype, stream)``;
        ``kernel.ABI``, the shipped one (the wrapper runs with ``lib`` in
        place of its own library).  Fails on any other."""
        from repro_torch.kernels import _build
        torch, Sd = self.torch, self.Sd
        SK = Sd.kernel
        abi = lib.ssd_abi() if hasattr(lib, "ssd_abi") else 1
        B, H, S, P = xv.shape
        N, Q = Bm.shape[-1], SSD_MAIN[5]
        if abi == SK.ABI:
            SK._bind(lib)

            def call():
                own = _build._loaded["ssd"]
                _build._loaded["ssd"] = lib
                try:
                    return Sd.ssd_chunked(xv, av, Bm, Cm, chunk=Q, n_heads=H)
                finally:
                    _build._loaded["ssd"] = own
            return call
        if abi != 1:
            fail("timing", f"--against: ssd_abi() is {abi}; this script "
                           f"calls interfaces 1 and {SK.ABI}")
        lib.ssd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                           ctypes.c_void_p]
        lib.ssd_launch.restype = ctypes.c_int
        y = torch.empty_like(xv)
        fs = torch.empty((B, H, N, P), device=xv.device)
        dims = (ctypes.c_longlong * 19)(
            B, H, S, P, N, Q, *xv.stride()[:3], *av.stride()[:3],
            *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3])

        def call():
            rc = lib.ssd_launch(xv.data_ptr(), av.data_ptr(), Bm.data_ptr(),
                                Cm.data_ptr(), y.data_ptr(), fs.data_ptr(),
                                dims, 1,
                                torch.cuda.current_stream().cuda_stream)
            if rc:
                fail("timing", f"the --against kernel failed to launch: {rc}")
            return y, fs
        return call

    def sdpa_bwd_ms(self, q, k, v, do):
        """One torch.autograd.grad through one causal
        scaled_dot_product_attention call on the same inputs, the KV heads
        repeated to the query heads before the call (PyTorch picks the
        backend).  Device ms per call."""
        torch = self.torch
        import torch.nn.functional as F
        g = q.shape[2] // k.shape[2]
        qh = q.transpose(1, 2).detach().requires_grad_()
        kh, vh = (x.transpose(1, 2).repeat_interleave(g, dim=1).detach()
                  .requires_grad_() for x in (k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        doh = do.transpose(1, 2)
        ms, _ = timed(lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                  retain_graph=True), 5,
                      torch)
        return ms

    def sdpa_ms(self, q, k, v, window):
        """One scaled_dot_product_attention call on the same inputs, the KV
        heads repeated to the query heads before the call.  With a window:
        a boolean mask (PyTorch's GQA path has no kernel for a mask) on the
        memory-efficient (or cuDNN) backend; without: is_causal=True, the
        backend PyTorch picks.  Device ms per call."""
        torch = self.torch
        from torch.nn.attention import SDPBackend, sdpa_kernel
        import torch.nn.functional as F
        S, g = q.shape[1], q.shape[2] // k.shape[2]
        qh = q.transpose(1, 2)
        kh, vh = (x.transpose(1, 2).repeat_interleave(g, dim=1)
                  for x in (k, v))
        if not window:
            ms, _ = timed(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True), 10, torch)
            return ms
        i = torch.arange(S, device=self.dev)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            ms, _ = timed(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), 5, torch)
        return ms

    def report(self, shape, name, src, replaces, k_dev, k_wall, p_dev,
               p_wall, nbytes, ops, n, note="", peak=F32_OPS_PER_S,
               library_ms=None):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        per_tick = f", {k_dev / n:.4f} ms/tick" if n > 1 else ""
        say("timing", f"{name} {shape}{' ' + note if note else ''}: kernel "
                      f"{k_dev:.4f} ms/launch on the device{per_tick} "
                      f"({k_wall:.4f} ms wall per call), plain version "
                      f"{p_dev:.4f} ms device ({p_wall:.4f} ms wall), bound "
                      f"{bound:.6f} ms ({nbytes} bytes: {bytes_ms:.6f} ms; "
                      f"{ops:.0f} ops: {ops_ms:.6f} ms)"
                      + (f", scaled_dot_product_attention {library_ms:.4f} ms"
                         if library_ms is not None else "")
                      + f", card {self.card}")
        if shape == MAIN_SHAPE[name]:
            pkg = {"switch_pipeline": "switch_pipeline", "ssd": "ssd"}.get(
                name, "flash_attention" if name.startswith("flash")
                else "netsim_tick")
            self.reports.append(dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/{pkg}/csrc/"
                       f"{src or name + '.cu'}",
                replaces=replaces, launches=self.launches.get(name, 0),
                max_abs_err=self.max_err[name], ms=k_dev, plain_ms=p_dev,
                bound_ms=bound,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms))

    # ------------------------------------------------------ 32. profile
    def profile(self):
        torch, T = self.torch, self.T
        from repro_torch.core.netsim.simulator import _window_body
        topo, wl, cfg = table1(T)
        n_run = 2000
        for tw in (1, 20):
            t1cfg = cfg._replace(n_ticks=n_run, sym_on=True, backend="cuda",
                                 tick_window=tw)
            torch.cuda.synchronize()
            t0 = time.time()
            t1 = T.simulate(topo, wl, t1cfg, routing="ecmp", seed=3,
                            device=self.dev)
            torch.cuda.synchronize()
            self.rates[("table1", tw)] = n_run / (time.time() - t0)
            if not torch.isfinite(t1.ts_throughput).all() or \
                    t1.ts_throughput.shape[0] != n_run // cfg.record_every:
                fail("profile", "Table-1 simulate returned malformed series")
        # where a main-path tick's time goes: ticks 300-499 alone (300-399
        # at 512 hosts)
        runs = (("table1", 1, None), ("table1", 20, None),
                ("multipod128", 20, None),
                ("multipod512", 1, BLK["multipod512"]),
                ("multipod512", 20, None))
        for shape, tw, blk in runs:
            topo, wl, cfg = SHAPES[shape](T)
            seeds = [3] if shape == "table1" else list(range(8))
            pcfg = cfg._replace(sym_on=True, backend="cuda", tick_window=tw,
                                blk=blk, segsum="onehot" if blk else "scatter")
            ctx, ecfg, sim = T.make_lanes(
                topo, wl, pcfg.structure(), pcfg.knobs(), seeds=seeds,
                device=self.dev)
            sim, _ = _window_body(ctx, ecfg, sim, 300)
            n_prof = 100 if shape == "multipod512" else 200
            wall_us, by_name = profile_ticks(
                lambda: _window_body(ctx, ecfg, sim, n_prof), torch)
            busy = sum(t for _, t in by_name.values())
            n_k = sum(n for n, _ in by_name.values())
            say("profile", f"{shape}, {ctx.B} lane(s), tick_window={tw}, "
                           f"blk={blk}, ticks 300-{299 + n_prof}: "
                           f"{wall_us / n_prof / 1e3:.3f} ms/tick wall, "
                           f"device busy {busy / n_prof / 1e3:.3f} ms/tick "
                           f"({100 * busy / wall_us:.1f}% busy), "
                           f"{n_k / n_prof:.2f} device kernels/tick")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
            for name, (n, t) in top:
                say("profile", f"  {t / n_prof / 1e3:.4f} ms/tick  "
                               f"{n / n_prof:.2f}/tick  {name[:80]}")
        r = self.rates
        say("profile", "main path (ticks/s, set-up included, not profiled): "
                       f"Table 1 1 lane through simulate {r[('table1', 1)]:.1f}"
                       f" (tick_window=1), {r[('table1', 20)]:.1f} "
                       "(tick_window=20); 128 hosts 8 lanes "
                       f"{r.get(('multipod128', 1), 0):.1f} (tick_window=1), "
                       f"{r.get(('multipod128', 20), 0):.1f} "
                       f"(tick_window=20); 512 hosts 8 lanes "
                       f"{r.get(('multipod512', 1), 0):.1f} (tiled, "
                       f"tick_window=1), {r.get(('multipod512', 20), 0):.1f}"
                       f" (tick_window=20); card {self.card}")
        self.profile_prefill()
        self.profile_train()
        self.profile_mamba()
        self.profile_granite()

    def profile_prefill(self):
        """One profiled 32,768-token prefill of the full-width model: the
        flash kernel's, the matrix products' and the rest's device time."""
        import numpy as np
        torch = self.torch
        model = self.danube_model()
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, model.cfg.vocab_size, (1, PREFILL_S))).to(self.dev)
        with torch.inference_mode():
            model.apply(tokens[:, :1024])
            wall_us, by_name = profile_ticks(lambda: model.apply(tokens),
                                             torch)
        busy = sum(t for _, t in by_name.values())
        flash = sum(t for name, (_, t) in by_name.items()
                    if "flash_fwd" in name)
        mm = sum(t for name, (_, t) in by_name.items()
                 if "flash_fwd" not in name and any(
                     w in name.lower() for w in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "matmul")))
        rest = busy - flash - mm
        say("profile", f"prefill 1 x {PREFILL_S} tokens (flash): "
                       f"{wall_us / 1e3:.1f} ms wall, device busy "
                       f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}% "
                       f"busy), {sum(n for n, _ in by_name.values())} device "
                       f"kernels; flash kernel {flash / 1e3:.1f} ms "
                       f"({100 * flash / busy:.1f}%), matrix products "
                       f"{mm / 1e3:.1f} ms ({100 * mm / busy:.1f}%), rest "
                       f"{rest / 1e3:.1f} ms ({100 * rest / busy:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (n, t) in top:
            say("profile", f"  {t / 1e3:.3f} ms  {n} launches  {name[:80]}")


    def profile_train(self):
        """One profiled training step of the full-width model (after a
        warm-up step): the loss and its gradients, then the AdamW update,
        each under the profiler; the flash forward's, dq's, dk/dv's, the
        matrix products', the optimizer's and the rest's device time."""
        torch = self.torch
        from repro_torch.optim import adamw_update, init_opt_state
        from repro_torch.runtime import make_loss_fn
        model = self.danube_model()
        tcfg = self.train_config()
        params = dict(model.named_parameters())
        opt = init_opt_state(params, tcfg)
        loss_fn = make_loss_fn(model, model.cfg)
        batch = self.train_batches(2)[1]
        held = {}

        def fwd_bwd():
            loss = loss_fn(batch)
            held["g"] = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))

        def update():
            held["opt"] = adamw_update(params, held.pop("g"), held["opt"],
                                       tcfg)[0]

        held["opt"] = opt
        del opt
        fwd_bwd()
        update()                                     # warm-up step
        wall_a, by_a = profile_ticks(fwd_bwd, torch)
        wall_b, by_b = profile_ticks(update, torch)
        del held
        busy_a = sum(t for _, t in by_a.values())
        busy_b = sum(t for _, t in by_b.values())

        def named(word):
            return sum(t for name, (_, t) in by_a.items() if word in name)

        fwd, dq, dkv = named("flash_fwd"), named("flash_dq"), \
            named("flash_dkv")
        mm = sum(t for name, (_, t) in by_a.items()
                 if "flash_" not in name and any(
                     w in name.lower() for w in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "matmul")))
        busy, wall = busy_a + busy_b, wall_a + wall_b
        rest = busy_a - fwd - dq - dkv - mm
        parts = [("flash forward", fwd), ("dq", dq), ("dk/dv", dkv),
                 ("matrix products", mm), ("optimizer", busy_b),
                 ("rest", rest)]
        say("profile", f"training step {TRAIN_B} x {TRAIN_S} tokens: "
                       f"{wall / 1e3:.1f} ms wall (loss and gradients "
                       f"{wall_a / 1e3:.1f}, AdamW {wall_b / 1e3:.1f}), "
                       f"device busy {busy / 1e3:.1f} ms "
                       f"({100 * busy / wall:.1f}% busy); "
                       + ", ".join(f"{n} {t / 1e3:.1f} ms "
                                   f"({100 * t / busy:.1f}%)"
                                   for n, t in parts))
        top = sorted(by_a.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (n, t) in top:
            say("profile", f"  {t / 1e3:.3f} ms  {n} launches  {name[:80]}")

    def profile_mamba(self):
        """One profiled mamba2-130m prefill of MAMBA_B x 32,768 tokens: the
        SSD kernels', the matrix products' and the rest's (conv, SiLU,
        norms, casts) share of device time."""
        torch = self.torch
        model = self.mamba_model()
        tokens = self.mamba_tokens()
        with torch.inference_mode():
            model.apply(tokens[:1, :1024])
            wall_us, by_name = profile_ticks(lambda: model.apply(tokens),
                                             torch)
        busy = sum(t for _, t in by_name.values())
        # every kernel of the SSD library, by its name in the source
        per = {k: sum(t for name, (_, t) in by_name.items()
                      if f"::{k}" in name or name.startswith(k))
               for k in self.Sd.kernel.KERNELS}
        ssd = sum(per.values())
        parts = ", ".join(f"{k} {t / 1e3:.1f} ms" for k, t in per.items())
        mm = sum(t for name, (_, t) in by_name.items()
                 if "ssd_" not in name and any(
                     w in name.lower() for w in ("gemm", "xmma", "nvjet",
                                                 "cutlass", "matmul")))
        rest = busy - ssd - mm
        B, S = tokens.shape
        say("profile", f"mamba2 prefill {B} x {S} tokens (SSD kernel): "
                       f"{wall_us / 1e3:.1f} ms wall, device busy "
                       f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}% "
                       f"busy), {sum(n for n, _ in by_name.values())} device "
                       f"kernels; SSD kernels {ssd / 1e3:.1f} ms "
                       f"({100 * ssd / busy:.1f}%: {parts}), matrix products "
                       f"{mm / 1e3:.1f} ms ({100 * mm / busy:.1f}%), rest "
                       f"{rest / 1e3:.1f} ms ({100 * rest / busy:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (n, t) in top:
            say("profile", f"  {t / 1e3:.3f} ms  {n} launches  {name[:80]}")

    def profile_granite(self):
        """One profiled granite prefill of MOE_B x 32,768 tokens: the flash
        kernel's, the matrix products', the MoE dispatch's (sorts, scatters,
        gathers and index copies: the routing's sort, the bucket ranks, the
        send and expert buffers, the gathers back) and the rest's share of
        device time.  Kernels are told apart by name; the embedding's one
        gather counts as dispatch."""
        torch = self.torch
        model = self.granite_model()
        tokens = self.family_tokens(model.cfg, MOE_B, PREFILL_S)
        with torch.inference_mode():
            model.apply(tokens[:1, :1024])
            wall_us, by_name = profile_ticks(lambda: model.apply(tokens),
                                             torch)
        busy = sum(t for _, t in by_name.values())

        def share(pred):
            return sum(t for name, (_, t) in by_name.items() if pred(
                name.lower()))

        def is_mm(n):
            return "flash_fwd" not in n and any(
                w in n for w in ("gemm", "xmma", "nvjet", "cutlass",
                                 "matmul"))

        def is_dispatch(n):
            return not is_mm(n) and any(
                w in n for w in ("sort", "scatter", "gather", "index",
                                 "topk", "searchsorted", "radix", "cub"))

        flash = share(lambda n: "flash_fwd" in n)
        mm, disp = share(is_mm), share(is_dispatch)
        rest = busy - flash - mm - disp
        self.rates["granite_profile"] = (wall_us, busy, flash, mm, disp)
        say("profile", f"granite prefill {MOE_B} x {PREFILL_S} tokens "
                       f"(flash): {wall_us / 1e3:.1f} ms wall, device busy "
                       f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}% "
                       f"busy), {sum(n for n, _ in by_name.values())} device "
                       f"kernels; flash kernel {flash / 1e3:.1f} ms "
                       f"({100 * flash / busy:.1f}%), matrix products "
                       f"{mm / 1e3:.1f} ms ({100 * mm / busy:.1f}%), MoE "
                       f"dispatch {disp / 1e3:.1f} ms "
                       f"({100 * disp / busy:.1f}%), rest {rest / 1e3:.1f} ms"
                       f" ({100 * rest / busy:.1f}%)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, t) in top:
            say("profile", f"  {t / 1e3:.3f} ms  {n} launches  {name[:80]}")


def against_sources(root: Path) -> dict:
    """The kernel sources of another commit that ``--against`` times beside
    the shipped kernels: ``{library: its csrc directory}`` for ssd,
    netsim_tiled and switch_pipeline, from ``root`` holding an ssd.cu (the
    SSD scan alone) or a ``src/repro_torch/kernels`` tree (``git archive
    <commit> src/repro_torch/kernels | tar -x -C root``)."""
    root = root.resolve()
    if (root / "ssd.cu").exists():
        return {"ssd": root}
    kernels = root / "src" / "repro_torch" / "kernels"
    found = {}
    for lib, pkg in (("ssd", "ssd"), ("netsim_tiled", "netsim_tick"),
                     ("switch_pipeline", "switch_pipeline")):
        if (kernels / pkg / "csrc" / f"{lib}.cu").exists():
            found[lib] = kernels / pkg / "csrc"
    return found


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    argv, against = list(argv), None
    if "--against" in argv:
        i = argv.index("--against")
        against = against_sources(Path(argv[i + 1])) \
            if i + 1 < len(argv) else {}
        if not against:
            print("chip_smoke: --against takes a directory holding an ssd.cu "
                  "or another commit's src/repro_torch/kernels tree",
                  file=sys.stderr)
            return 2
        del argv[i:i + 2]
    phases = argv or list(PHASES)
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; have {PHASES}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    smoke.against = against
    t_all = time.time()
    say("all", f"host probe {host_ms():.1f} ms, load "
               f"{os.getloadavg()[0]:.2f}, {os.cpu_count()} CPUs")
    if "launch" in phases:
        smoke.start_launch()
    try:
        for p in PHASES:
            if p in phases:
                if p == "launch" and "goldens" in phases:
                    smoke.start_goldens()
                t0 = time.time()
                getattr(smoke, p)()
                say(p, f"phase done in {time.time() - t0:.1f} s (host probe "
                       f"{host_ms():.1f} ms, load {os.getloadavg()[0]:.2f})")
    finally:
        for pool in (smoke.launch_pool, smoke.golden_pool):
            if pool is not None:
                pool.shutdown(cancel_futures=True)
    say("all", f"{len(phases)} phases in {time.time() - t_all:.1f} s")
    if phases != list(PHASES):
        return 0
    print(json.dumps({"kernels": smoke.reports}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
