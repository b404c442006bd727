#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

  1. build   -- one ``nvcc`` per kernel library, started together:
     ``src/repro_torch/csrc/fused_update.cu``,
     ``src/repro_torch/csrc/ssd.cu`` and
     ``src/repro_torch/csrc/flash_attention.cu``.
  2. kernels -- each CUDA kernel against its plain PyTorch version on the
     card, on the same inputs, within TOLS: at the main path's shapes (the
     8 leaves of the paper's MNIST CNN) and at bank-sized shapes, f32, bf16
     and f32 params with bf16 deltas, and at mamba2-130m's 12 leaves (M = 4,
     the window apply of (f)).  ``ssd_fwd`` against ``ssd_ref`` within
     SSD_TOL at SSD_CASES (the (f) cohort, (8, 4096) and (1, 32768)), f32
     and bf16 inputs, with a shared a_log, and at SSD_ROW_CASES with a
     per-row (B, H) a_log, the layout (f)'s cohort hands the kernel; chunk
     32/64/128 within SSD_CHUNK_TOL; and at zamba2's SSD_ZAMBA_DIMS (N = 64,
     H = 64) at SSD_ZAMBA_CASES, bf16, per-row a_log; at SSD_GROUP_CASES
     (G = 2, chunk 64); every case also against ``ssd_phases_ref`` (the
     plain model of the kernels' three phases) within SSD_TOL, with the
     kernels per call, scratch bytes and the design's bytes reported.
     ``flash_attention_fwd`` against ``attention_ref`` and
     ``attention_tiles_ref`` (the plain model of its kernels' arithmetic)
     within FLASH_TOL at FLASH_CASES ((i)'s cohort, (2, 4096) f32 and
     bf16, gemma2-like hd 256 with softcap and GQA, MQA, a tail at S =
     1000, (1, 32768), checked on its first and last 256 rows, (j)'s (8,
     4096) with its plain versions one batch row at a time, bf16 tail,
     hd 128 MQA and hd 128 softcap cases, and gemma2-2b's bf16 hd-256
     shapes: (8, 4096) and (1, 32768) with its window of 4096 and
     without, (r)'s cohort (4, 128), one partial tile (2, 8) and a tail at
     S = 1000 with a window of 300; an hd-256 MQA case without a
     softcap; and granite-moe-1b-a400m's prefill shapes, bf16 GQA 16/8 of
     64, causal with no window, at (8, 4096) and (1, 32768), and at
     (u)'s cohort (4, 128)).  Its non-causal, cross-length branch (the
     encdec family's) within FLASH_XTOL at FLASH_XCASES: whisper's
     encoder, bf16 20/20 x 64 non-causal at (8, 1500 x 1500) and (x)'s
     cohort (4, 1500 x 1500); its cross-attention at (8, 448 x 1500) and
     (4, 128 x 1500); f32 non-causal and cross with T = 200; causal with T
     != S both ways (offset 0) in f32 and bf16; hd 128 and capped hd 256
     with T = 200; each must also tell its answer from the other mask's
     and from the one that scores the last key tile's rows past T (zeros)
     as 0.  The library time of a case with a softcap is a compiled
     ``flex_attention`` call's, SDPA's otherwise; a softcap case is also
     timed with the cap off (``ms_no_softcap``), and every row carries its
     kernel's registers and spills from nvcc's ``-Xptxas -v`` report (the
     wgmma kernel must not spill).
     Each case also shows that a
     no-op (a zero output for the scan) and a sign-flipped result fail the same
     check, each per-row case that row 0's a_log for every row does, each
     windowed attention case that the output without the window does, and
     each softcap case that the output without the softcap does.
     ``apply_scaled``, ``apply_rows`` and ``apply_rows_q`` run through
     their tree fronts ``ops.apply_delta_tree``, ``ops.apply_rows_tree`` and
     ``ops.apply_rows_q_tree`` (each leaf with its own row scales), the main
     path's entry points; two ``apply_rows`` or ``apply_rows_q`` calls on the
     same inputs must give the same bits.  The local steps ``sgd_step``,
     ``prox_inner`` and ``prox_outer`` through their tree fronts
     (``ops.<name>_tree``, the entry points that run them, as in the
     reference), ``mode="kernel"`` against ``mode="ref"`` within TOLS: at
     the CNN's 8 leaves, at LOCAL_CASES (n = 2^26+3; f32, bf16, f32 with
     bf16 other operands) and at the full param trees of mamba2-130m (12
     leaves) and zamba2-1.2b (21 leaves), f32.  The window applies of (f),
     (i), (r) and (u) at M = 4: mamba2's 12 leaves, zamba2's 10 personal
     ones, gemma2's unembedding (589,824,000 params) and granite's
     (50,334,720 params).  Every checked call's
     launches are counted (zeroed just before, read just after) and must
     be the planned count: every fused-update kernel takes a table of
     leaves (TABLE_KERNELS), one launch per dtype combination of a leaf's
     operands and chunk of ``max_leaves()`` leaves.  All six also run on
     TABLE_SIZES' awkward trees (empty, 1-10 element and 2^20+5 element
     leaves, views 4 bytes past a 16-byte boundary, a mixed f32/bf16 leaf)
     and on a tree of 3·max_leaves()+1 leaves, f32 and bf16, NaN-poisoned
     outputs: error 0, and for ``apply_rows`` and ``apply_rows_q`` (int8
     stacks, each leaf's own scales), with stacks of TABLE_ROWS rows (0, 1,
     and 1100 with a run of zero-weight rows; rows that are not 16-byte
     aligned, int8 rows that start off a word), within TOLS and bit-equal
     over two calls, M = 0 giving w.
     The CNN rows also time ``torch._foreach_add`` (``torch._foreach_lerp``
     for ``prox_outer``) over the tree
     (``foreach_ms``), per-leaf ``torch.empty_like`` against one flat
     buffer with leaf views, and the host time of each step of the front
     (``host_us``).
     Times are medians of CUDA-event timings; ``bound_ms`` is the larger of
     the bytes the function must move over the H100 SXM's 3.35 TB/s and its
     FLOPs over the card's peak for the operands' type (for ``ssd_fwd`` and
     ``flash_attention_fwd``: 989 TFLOP/s on the bf16 tensor cores, 67
     TFLOP/s in f32 outside them), with the f32 CUDA-core bound, the
     ceiling of a design that multiplies on the CUDA cores (the f32
     paths), beside it; ``library_ms``
     times one PyTorch call that
     computes the same function (a yardstick the port never calls; none
     exists for the scan, for attention with a softcap, for ``prox_inner``
     (a step of three operands), for the int8 stack times per-row scales
     or, except ``torch.add``, for mixed dtypes).
  3. main path -- PersA-FL asynchronous training of the paper CNN on
     label-skewed synthetic MNIST (the fig2 setup of
     ``benchmarks/common.py``: 30 clients, 5 classes each, batch 16, Q = 10,
     λ = 25, 10 inner steps) through ``FLRun(device="cuda")``:
     (a) Option C, immediate, 75 rounds; (b) Option C, buffered(8), 80
     rounds; (c) Option B full, immediate, 10 rounds; (d) Option A,
     η = 0.01, sync_barrier(10), 5 rounds.  The launch counters are zeroed
     just before (a) and read just after (d).
  4. checks  -- both kernels were launched in (a)-(d), ``apply_scaled``
     once per immediate apply and ``apply_rows`` once per stacked apply (the
     CNN's 8 leaves are one table), params are finite,
     and the first 8 rounds of (a) and (b), run on the card and on the CPU,
     give the same event timeline and params within PARAM_ATOL.
  5. serving -- (e) the personalization server on the same 30 users
     (``PersonalizationServer(device="cuda")``, Option C, λ = 25, K = 5,
     η_in = 0.02, β = 1, 16 images per request): 12 windows with fp32 and
     with int8 delta banking (a few users resubmitted at every third window
     are applied one window late, τ = 1), 4 windows head-only int8
     (``personal_subset="fc/#1"``) and 4 windows of mode B.  Launch counters
     are zeroed just before (e) and read just after.  Checks: no host
     materialization, int8/fp32 ring bytes per user ≥ RING_RATIO,
     personalized accuracy of the two 12-window servers within ACC_GAP,
     per contributing bank ``apply_rows_q`` (int8) or ``apply_rows`` (fp32)
     launched once, and the first 3 int8 windows on the CPU within the
     tolerance stated at ``serving_cpu_parity``.

  6. mamba2-130m -- (f) ``repro_torch.launch.serve.main`` at full width
     (167,598,528 params), 4 users, mode C (λ = 30, α = 0.01, K = 5,
     η_in = 0.01), fp32 and int8 banking, 16 decoded tokens, then one
     ``advance_window()``; counts zeroed just before each run and read
     just after it.  Checks: no host materialization, ``ssd_fwd`` launched
     24 times per forward evaluation of the LM loss in the run (6 per
     cohort call, whatever the cohort size), every user's personalized loss
     below the global loss on their own stream, the window apply one
     ``apply_rows`` launch (fp32) or one ``apply_rows_q`` launch (int8).
     (g) ``make_prefill_step`` at PREFILL_SHAPES, bf16 activations: wall per
     call, 24 launches per call, and one call under ``torch.profiler``
     (device time in ``ssd_fwd`` against the GEMMs, device busy share).
     (h) the same weights at 2 layers, f32, card against CPU:
     ``prefill_logits`` within LM_PREFILL_TOL and the heads of one mode-C
     flush of 2 users within LM_HEAD_TOL.

  7. zamba2-1.2b -- (i) ``launch.serve.main`` at full width (1,183,058,816
     params in 21 leaves), 4 users, ``--personal-subset
     shared,embed/unembed``, as (f) otherwise: ``ssd_fwd`` launched 38 and
     ``flash_attention_fwd`` 6 times per forward evaluation of the loss,
     the window apply as in (f) over the personal leaves.  (j) prefill as (g),
     38 + 6 launches per call.  (k) the same architecture at 6 layers (one
     shared invocation), f32, card against CPU, as (h), with (i)'s subset.

  8. baselines -- (l) the paper's Figure 2 baselines on the fig2 setup
     (``benchmarks/common.py:48-72``: Option A batches, η = 0.01, batch 16)
     through ``FLRun(device="cuda")``: FedProx (μ = 0.1) under
     sync_barrier(10) for 5 rounds, SCAFFOLD under sync_barrier(10) for 5
     rounds and under buffered(8) for 20 server rounds; counts zeroed just
     before and read just after.  Checks: finite params, accuracy in
     [0, 1], no host materialization, ``apply_rows`` launched once per
     stacked apply; then 2
     rounds of each sync run twice on the card and once on the CPU:
     identical timeline, params and SCAFFOLD's c_global within PARAM_ATOL,
     and the card-against-card spread printed.

  9. scenario and tuner -- (m) the ``scale`` row of
     ``benchmarks/run.py:963-1060`` at SCALE_NS clients (10^3 to 10^6): the
     ``DeviceScheduler`` on the card (``SCALE_SCHED``: 30 s windows, cohort
     cap 256, 8 cycles a window; speed tiers, a diurnal curve, 2% dropout,
     5% scale / sign-flip adversaries), one warm-up window and SCALE_WINDOWS
     timed ones, each cohort corrupting a seeded [256, 2^16] f32 bank
     (``scale_rows``), admitted through the robust clip path and applied
     by one ``apply_admitted_rows`` (``apply_rows``, once a window).
     Checks: at SCALE_ORACLE_N clients the first window against the
     float64 ``EventStream`` (ids exactly, times within rel 1e-4, the
     window's edge and the cap's cut left out) and the first 3 windows
     against the same scheduler on the CPU (ids and stats exactly); 0 host
     materializations; s/window at 10^6 within 0.2 × the client ratio of
     s/window at 10^3; the device kernels of a window from
     ``torch.profiler``.  (n) the MNIST CNN under
     ``examples/scenario_churn.py:70-85``'s churn (30 clients, two speed
     tiers, 5% dropout, 10% ×50 / sign-flip adversaries), Option A,
     ``buffered(8)`` plain and with ``robust="clip"``, 48 rounds, each
     with ``scheduler="device"`` and ``"heap"``: identical histories and
     params bit for bit (cuDNN's deterministic algorithms), corrupted rows,
     clipped rows under clip, finite params under clip, ``apply_rows`` once
     per stacked apply.  (o) a 4-arm ``TuneRunner`` sweep (persafl /
     fedprox × immediate / buffered(8)) under (n)'s churn with
     ``default_rules()``, journaled: arms on one seed evaluate at the same
     simulated times, and a second sweep over the journal skips every arm;
     then one arm under a rule sure to fire (``AccPlateau(1, 2.0)``) stops
     at its second eval, on its first run's timeline.  Counts are zeroed
     just before each of (m)'s timed loops, (n) and (o)'s first sweep, and
     read just after.  (p) the two event sources ``FLRun`` chooses between,
     on the host: the heap and the ``EventStream`` at EVENT_NS clients
     under ``DelayModel`` and the scale row's churn, EVENT_COUNT events
     each, the same events tuple for tuple; the seconds to the first event
     and to the last, and where ``scheduler="auto"`` switches.

 10. transport -- (q1) the ``serve_transport`` row of
     ``benchmarks/run.py:426-540`` at its size (XPORT: d = 256, 10
     classes, 32 rows a request, 32 connections, mode C, λ = 20, K = 200,
     η_in = 0.01, β = 0.5, ``max_pending`` 32, ``flush_ms`` 100,
     ``max_inflight`` 128): the port's ``TransportServer`` in front of
     ``PersonalizationServer(device="cuda")`` here, the load from a second
     OS process (LOADGEN: the port's ``AsyncTransportClient``s, batches
     from ``RandomState(0)``), 1 warm-up window and 8 × 3 timed ones with
     an ADVANCE after each, and the same windows in-process on a second
     server; counts zeroed just before the socket drive and read just
     after.  Checks: every POLL done, one cohort call and one
     ``apply_rows`` launch per window, 0 host materializations, the first
     window's heads over the wire bit-equal to the in-process server's
     (cuDNN deterministic), the same window on the CPU within PARAM_ATOL,
     and an int8 ``codec_ok`` head body from an int8-banking server at the
     quant bench's 256 × 256 ≥ WIRE_RATIO smaller than an fp32 one.
     Reports req/s over the socket and in-process, their ratio beside the
     row's 1.5 (not gated), p50/p99 submit→head and body bytes.  (q2)
     ``python -m repro_torch.launch.serve --arch mamba2-130m --listen 0
     --personal-subset embed/unembed --delta-dtype int8 --flush-ms
     1000`` as a child on the card for LISTEN_SECONDS, driven from here by
     4 users submitting together (one
     ``codec="int8"``): 4 heads done, the subset stamped, ``codec`` int8
     only for that client, HEAD's body equal to POLL's, one ADVANCE,
     STATS with one cohort call and 0 host materializations, the child's
     own counts (144 ``ssd_fwd``, 1 ``apply_rows_q``), and the child
     exiting 0 within LISTEN_SECONDS + 10 s of its line with a connection
     still open.

 11. gemma2-2b (``models/lm.py``) -- (r) ``launch.serve.main`` at full
     width (3,204,165,888 params in 14 leaves, drawn on the host: its
     seconds printed), GEMMA2_USERS = 4 users on personalization streams
     of GEMMA2_PLEN = 128 tokens (``--personalize-len``),
     ``--personal-subset embed/unembed``, as (f) otherwise:
     ``flash_attention_fwd`` launched 26 times per forward evaluation of
     the loss (one per layer, its window decided per layer: 4096 on the
     even, local layers, none on the odd, global ones), the window apply
     one ``apply_rows`` / ``apply_rows_q`` launch, the peak of device
     memory printed, and the int8 server's second flush split by the line
     that allocated each block live at its peak.  (s) prefill as (g), 2
     timed calls after a warm-up, 26 launches per call; the (8, 4096)
     call's profile read by both device-event readers, which must agree.  (t) card against CPU, f32: gemma2 at
     2 layers (layer 0 local, 1 global) at GEMMA2_PARITY_SHAPE, past the
     window, ``prefill_logits`` within LM_PREFILL_TOL and an all-global
     copy of the config outside it; codeqwen1.5-7b at 2 layers with
     non-zero QKV biases; both ``prefill_logits`` only, their params drawn
     on the card and copied to the host.

 12. the moe family (``models/moe.py``, MLA) -- (u) granite-moe-1b-a400m's
     ``launch.serve.main`` at full width (1,384,963,072 params in 13
     leaves, drawn on the host), GRANITE_USERS = 4 users on
     GRANITE_PLEN = 128-token streams, ``--personal-subset
     embed/unembed``, fp32 then int8, as (r) otherwise:
     ``flash_attention_fwd`` launched 24 times per forward evaluation (one
     per layer, causal, no window), the window apply one ``apply_rows`` /
     ``apply_rows_q`` launch, and the (token, slot) pairs capacity drops
     in a forward of the cohort's batch at the global params, one group of
     128 tokens a user (C = 40), as the vmapped cohort forward groups them.
     (v) prefill as (s), 2 timed calls a shape, 24 launches per call, its
     device time split into elementwise passes, GEMMs,
     ``flash_attention_fwd`` and the MoE's routing and dispatch kernels
     (sort, scan, scatter, gather, index_select), each named.  (w)
     card against CPU, f32: granite at 2 layers at (2, 256), where
     capacity binds, ``prefill_logits`` within LM_PREFILL_TOL, the same
     count of dropped pairs on both sides, and the subset heads of one
     mode-C flush of 2 users within LM_HEAD_TOL; deepseek-v3-671b cut to
     DEEPSEEK_CUT (1 dense-prefix layer, 1 MoE layer of 16 of its 256
     experts and its shared expert, the MTP block; every width published:
     45 leaves, 3,706,691,584 params, drawn on the card by the port's own
     init from a CUDA generator and copied to the host) at (1, 128): the
     loss with its aux
     and 0.1 x MTP terms and ``prefill_logits`` within LM_PREFILL_TOL, and
     8 absorbed-MLA decode steps on the card against the card's prefill
     logits within DECODE_TOL; no kernel launches in (w)'s deepseek part.

 13. the encdec family (``models/encdec.py``) -- (x) whisper-large-v3's
     ``launch.serve.main`` at full width (1,600,990,720 params in 25
     leaves, drawn on the host), WHISPER_USERS = 4 users on WHISPER_PLEN =
     128-token streams, each with the 1500 zero frames of the stubbed
     frontend, ``--personal-subset embed/unembed`` (66,388,480 params a
     user), fp32 then int8, as (u) otherwise: ``flash_attention_fwd``
     launched 96 times per forward evaluation (32 non-causal encoder, 32
     causal and 32 cross decoder layers) and 32 more for the decode
     cache's encoder, the window apply one ``apply_rows`` /
     ``apply_rows_q`` launch.  (y) prefill as (s) at WHISPER_PREFILL_SHAPES
     (8 and 32 rows of its published 448-token decoder context, each with
     1500 zero frames), 2 timed calls a shape, 96 launches per call,
     decoder tokens and encoder frames per second.  (z) card against CPU,
     f32: 2 encoder and 2 decoder layers at published widths and enc_len
     1500, (2, 64) tokens with unit-normal frames: the loss and
     ``prefill_logits`` within LM_PREFILL_TOL, 12 launches, and 8 decode
     steps on the card against its teacher-forced logits within
     DECODE_TOL.

 14. training (``launch/train.py``) -- (T1) ``launch.train.main --preset
     paper-mnist`` cut to 100 rounds and ``--preset paper-cifar`` cut to
     20 (TRAIN_PRESETS), Option C at the driver's defaults (30 clients, Q =
     10, K = 10, batch 16): s/round, the accuracy series, staleness, the
     active ratio, ``apply_scaled`` launched once per immediate apply and no
     stacked apply, the checkpoint read back by the port's
     ``load_server_state`` equal to the run's state bit for bit, and the
     busy share of a run of TRAIN_PROFILE_ROUNDS rounds.  (T2)
     ``launch.train.main --arch`` for mamba2-130m and granite-moe-1b-a400m
     at published width, (8, 512), Option C with Q and K cut to TRAIN_CUT
     (2 and 2), TRAIN_ROUNDS rounds: s/round, losses, peak device memory,
     ``ssd_fwd`` / ``flash_attention_fwd`` launched 24 times per forward
     evaluation (Q·(K+1) gradient evaluations and the round's loss) and
     ``apply_scaled`` once a round, model TFLOP/s by the reference's count
     (6 · active params · tokens per gradient evaluation,
     ``src/repro/launch/roofline.py:69-82``) against the bf16 peak; one
     more round under the profiler (busy share, device time by kernel
     class) and one gradient evaluation with the device time of the plain
     attention and SSD backward passes (their autograd nodes) named.  (T3)
     one ``make_train_step`` round of each at 2 layers, published widths,
     f32, Option C, Q = 2, K = 2, (2, 128), card against CPU: new params
     within PARAM_ATOL, ``delta_norm`` within TRAIN_NORM_RTOL, the launches
     planned.  The kernel rows gain the training shapes (granite's
     attention and mamba2's scan at (8, 512), bf16), and ``apply_scaled``,
     ``ssd_fwd`` and ``flash_attention_fwd`` a ``launches_train`` count of
     (T1)-(T3).

 15. the multi-device paths on a one-rank mesh (``nccl``; the card's
     machine has one H100 and NCCL refuses two ranks on one card) --
     (M2) ``launch.serve.main --arch mamba2-130m --personalize
     --model-axis 1 --coordinator 127.0.0.1:<free port> --num-processes 1
     --process-id 0`` at (f)'s flags, fp32, against the same command on one
     device with the server's engines mapping rows one at a time: the same
     heads and tokens bit for bit, 0 host materializations, ``ssd_fwd`` 24
     launches a loss evaluation of a row; (f)'s vmapped heads reported
     beside them.  (M1) the fig2 setup at Option A under buffered(8) for
     MESH_ROUNDS rounds with ``cohort_impl="map"``, ``"shard_map"`` on the 1-D mesh and
     on the (1, 1) mesh with every leaf's last dim on "model" (cuDNN
     deterministic): params bit-equal, timelines equal, ``apply_rows`` once
     per stacked apply; the sequential mode against ``rows_kernel`` on a
     sharded bank within TOLS; then the (e) users under int8 banking for
     MESH_SERVE_WINDOWS windows with stragglers on one device and on the
     (1, 1) mesh: params and heads bit-equal, ``apply_rows_q`` once per
     bank.  (M3) ``make_cohort_train_step`` on ``make_host_mesh()`` against
     ``make_train_step``, mamba2-130m at 2 layers, published widths, f32,
     (2, 128): bit-equal.  The kernel rows gain ``launches_mesh``.

Each group of phases prints its seconds (``phase <label>: <s> s``).

It prints the card's name and power limit first, one ``{"kernels": [...]}``
line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
KERNEL_LIBS = ("fused_update", "ssd", "flash_attention")
SOURCES = {"sgd_step": "src/repro_torch/csrc/fused_update.cu",
           "prox_inner": "src/repro_torch/csrc/fused_update.cu",
           "prox_outer": "src/repro_torch/csrc/fused_update.cu",
           "apply_scaled": "src/repro_torch/csrc/fused_update.cu",
           "apply_rows": "src/repro_torch/csrc/fused_update.cu",
           "apply_rows_q": "src/repro_torch/csrc/fused_update.cu",
           "ssd_fwd": "src/repro_torch/csrc/ssd.cu",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {"sgd_step": "src/repro/kernels/fused_update/kernel.py:78",
            "prox_inner": "src/repro/kernels/fused_update/kernel.py:83",
            "prox_outer": "src/repro/kernels/fused_update/kernel.py:90",
            "apply_scaled": "src/repro/kernels/fused_update/kernel.py:229",
            "apply_rows": "src/repro/kernels/fused_update/kernel.py:129",
            "apply_rows_q": "src/repro/kernels/fused_update/kernel.py:186",
            "ssd_fwd": "src/repro/kernels/ssd/kernel.py:73",
            "flash_attention_fwd":
                "src/repro/kernels/flash_attention/kernel.py:69"}
# CPU-vs-card agreement of the 8-round runs.  The card's cuDNN and the CPU's
# oneDNN sum the f32 convolutions in different orders, so every gradient
# differs in its last bits; Option C then forms λ(w − θ̃) from two nearly
# equal params (λ = 25), which magnifies those bits, and each round chains
# Q = 10 steps of 11 gradients onto params that the earlier rounds already
# moved.  An H100 run of (a) differed from the CPU by 5.7e-5 at most.
PARAM_ATOL = 1e-4
# params that far apart move the logits enough to flip near-ties: allow 1%
# of the 30 x 64 personalized test predictions (an H100 run of (a) flipped
# 4 of them, 0.0021)
ACC_ATOL = 0.01
# kernel against plain version on the card.  f32 apply_scaled: one
# elementwise f32 pass, rounded as the plain version rounds it.  f32
# apply_rows: the M rows are summed in another order.  bf16 output: about
# one bf16 ulp (8 significant bits), for a sum rounded from a slightly
# different f32 value.  Every case checks that a no-op and a sign-flipped
# result fail these limits.
TOLS = {"apply_scaled": dict(atol=1e-6, rtol=0.0),
        "sgd_step": dict(atol=1e-6, rtol=0.0),
        "prox_inner": dict(atol=1e-6, rtol=0.0),
        "prox_outer": dict(atol=1e-6, rtol=0.0),
        "apply_rows": dict(atol=1e-5, rtol=1e-4),
        "apply_rows_q": dict(atol=1e-5, rtol=1e-4),
        "bf16": dict(atol=1e-5, rtol=2.0 ** -7)}
# bank-sized kernel cases, (n, w dtype, d dtype) and (M, n, w dtype, d
# dtype), beside the CNN's leaves.  Ragged n leaves a tail past every
# vector width, and a stack of n = 2^k+5 has rows that are not 16-byte
# aligned (apply_rows moves them element by element); M = 1500, ragged and
# aligned, with a run of zero-weight rows; w f32 with d bf16 is what
# PersAFLConfig(delta_dtype="bfloat16") hands both kernels.
SCALED_CASES = ((2 ** 26 + 3, "f32", "f32"), (2 ** 26 + 3, "bf16", "bf16"),
                (2 ** 26 + 3, "f32", "bf16"))
ROWS_CASES = ((1, 2 ** 20 + 5, "f32", "f32"), (8, 2 ** 20 + 5, "f32", "f32"),
              (300, 2 ** 20 + 5, "f32", "f32"),
              (1500, 2 ** 18 + 5, "f32", "f32"),
              (1500, 2 ** 18, "f32", "f32"), (8, 2 ** 24, "f32", "f32"),
              (8, 2 ** 20 + 5, "bf16", "bf16"),
              (8, 2 ** 20 + 5, "f32", "bf16"))
# apply_rows_q, (M, n, w dtype), beside the CNN's leaves at M = 32 (a
# 30-user window in its pow2 bucket): M = 1500 with a run of padding rows;
# bf16 at M = 300 is past the TPU kernel's 128-row chunk, where only the
# plain version computes the port's function.  n = 2^20+5 gives int8 rows
# that start off a word (read as the words around them and shifted into
# place), n = 2^20 and 2^24 aligned ones
ROWS_Q_CASES = ((1, 2 ** 20 + 5, "f32"), (8, 2 ** 20 + 5, "f32"),
                (300, 2 ** 20 + 5, "f32"), (300, 2 ** 20, "f32"),
                (1500, 2 ** 20 + 5, "f32"),
                (8, 2 ** 24, "f32"), (8, 2 ** 20 + 5, "bf16"),
                (300, 2 ** 20 + 5, "bf16"))
# the local steps through their tree fronts: name -> (scalars, scale of g
# against w).  Option A's η, Option C's η_in and λ; η = 0.01 and λ = 20 make
# an ηλ whose f64 product rounds to another f32 than f32(η)·f32(λ).  g is
# scaled so that η·|g| and ηλ·|w − θ| are of the order of |w|: at η = 0.01
# and g like w a no-op would pass one bf16 ulp
LOCAL_STEPS = {"sgd_step": (dict(eta=0.01), 50.0),
               "prox_inner": (dict(eta_in=0.02, lam=20.0), 25.0),
               "prox_outer": (dict(eta=0.01, lam=20.0), None)}
# (n, first operand's dtype, the other operands' dtype), beside the CNN's
# leaves and the two LMs' full param trees
LOCAL_CASES = ((2 ** 26 + 3, "f32", "f32"), (2 ** 26 + 3, "bf16", "bf16"),
               (2 ** 26 + 3, "f32", "bf16"))
# the kernels that take a whole param tree in one launch, through a table of
# leaves (apply_rows: of leaves and their stacks; apply_rows_q: of leaves,
# their int8 stacks and their row scales): all six fused-update kernels
TABLE_KERNELS = ("apply_scaled", "sgd_step", "prox_outer", "apply_rows",
                 "prox_inner", "apply_rows_q")
FIG2 = dict(q_local=10, beta=1.0, alpha=0.01, lam=25.0, inner_steps=10,
            inner_eta=0.02, maml_mode="full")
# serving phase (e): the quant bench's convergence configuration
# (benchmarks/run.py:806-940) at full width, 30 users, 16 images per request
SERVE = dict(option="C", lam=25.0, inner_steps=5, inner_eta=0.02, beta=1.0,
             alpha=0.01)
SERVE_WINDOWS, SERVE_BATCH, SERVE_STRAGGLERS = 12, 16, 4
# int8 vs fp32 banking after 12 windows: the quant bench's gate 4
ACC_GAP = 0.1
# bytes per user of the int8 ring against the fp32 ring: the quant bench's
# gate 2
RING_RATIO = 3.5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def timed(label: str):
    """Print the seconds the enclosed phases took."""
    t0 = time.perf_counter()
    yield
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, launches: int = 20, repeats: int = 5,
            warmup: int = 3) -> float:
    """Time of one call of ``fn``: CUDA events around ``launches`` calls in
    a row, over the count, median of ``repeats`` such runs.  Where a call's
    host work outlasts its kernel, this is the host's time per call."""
    return time_interleaved(torch, {"fn": fn}, launches, repeats,
                            warmup)["fn"]


def time_interleaved(torch, fns, launches: int = 20, repeats: int = 9,
                     warmup: int = 3):
    """:func:`time_ms` of each callable of ``fns`` (name -> callable, or
    None), their runs taken in turn, forwards then backwards, so that a
    drift of the host's speed (the card's machine shares its cores) reaches
    each alike.  Returns name -> ms, None for None."""
    live = [(k, f) for k, f in fns.items() if f is not None]
    for _, f in live:
        for _ in range(warmup):
            f()
    torch.cuda.synchronize()
    times = {k: [] for k, _ in live}
    for r in range(repeats):
        for k, f in (live if r % 2 == 0 else live[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                f()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / launches)
    return {k: statistics.median(times[k]) if k in times else None
            for k in fns}


def leaves_close(torch, got, want, tol):
    """Max abs error over a list of leaves, and whether every leaf is within
    ``tol``."""
    err = max(float((a.float() - b.float()).abs().max()) if a.numel()
              else 0.0 for a, b in zip(got, want))
    ok = all(torch.allclose(a.float(), b.float(), **tol)
             for a, b in zip(got, want))
    return err, ok


def planned_launches(K, firsts, *others) -> int:
    """Launches a leaf-table front (TABLE_KERNELS) makes for its leaves
    ``firsts`` and the trees of its other operands ``others`` (for
    ``apply_rows`` the leaves' stacks, for ``apply_rows_q`` their stacks
    and their scales): one per dtype combination of a leaf's operands and
    chunk of ``K.max_leaves()`` non-empty leaves, whatever M."""
    combos = collections.Counter(
        tuple(x.dtype for x in leaf) for leaf in zip(firsts, *others)
        if leaf[0].numel())
    return sum(-(-c // K.max_leaves()) for c in combos.values())


def host_us(torch, fns, calls: int = 200, repeats: int = 9):
    """Host microseconds per call of each callable of ``fns`` (name ->
    callable): the host clock around ``calls`` calls, the card's queue
    drained first, the callables in turn as in :func:`time_interleaved`;
    median of ``repeats``."""
    fns = list(fns.items())
    for _, f in fns:
        f()
    times = {k: [] for k, _ in fns}
    for r in range(repeats):
        for k, f in (fns if r % 2 == 0 else fns[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            times[k].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def front_host_breakdown(torch, K, ops, ws, ds, s):
    """Where the host time of ``ops.apply_delta_tree(mode="kernel")`` goes
    on a tree (a dict of the leaves ``ws``, ``ds``): each step of the front
    timed alone, beside the whole front, one ``torch.add`` per leaf and
    ``torch._foreach_add``."""
    from repro_torch.tree import tree_leaves, tree_unflatten
    wt = {f"{i:02d}": w for i, w in enumerate(ws)}
    dt = {f"{i:02d}": d for i, d in enumerate(ds)}
    outs = [torch.empty_like(w) for w in ws]
    args = (("w", ws), ("d", ds))
    plan = K.plan_launches("apply_scaled", args, outs, K.max_leaves())
    fn, dev = K._lib().fu_sub_scaled_leaves, ws[0].get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)

    def launch():
        for launch in plan:
            fn(launch.words.buffer_info()[0], len(launch.leaves), s,
               *launch.codes, stream)

    def device_ctx():
        with torch.cuda.device(dev):
            pass
    steps = {
        "front": lambda: ops.apply_delta_tree(wt, dt, s, mode="kernel"),
        "tree_leaves x2": lambda: (tree_leaves(wt), tree_leaves(dt)),
        "tree_unflatten": lambda: tree_unflatten(wt, outs),
        "empty_like": lambda: [torch.empty_like(w) for w in ws],
        "check and plan": lambda: K.plan_launches("apply_scaled", args, outs,
                                                  K.max_leaves()),
        "device context": device_ctx,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "ctypes launch": launch,
        "torch.add per leaf": lambda: [torch.add(w, d, alpha=-s)
                                       for w, d in zip(ws, ds)],
        "torch._foreach_add": lambda: torch._foreach_add(ws, ds, alpha=-s),
    }
    return host_us(torch, steps)


def kernel_phase(torch, cnn_shapes, lm_cases=()):
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    f32, bf16 = torch.float32, torch.bfloat16
    results = {"apply_scaled": [], "apply_rows": [], "apply_rows_q": []}

    def randn(*shape, scale=1.0, dtype=f32):
        return (scale * torch.randn(*shape, device=dev, generator=g)
                ).to(dtype)

    def row_weights(m):
        # β/M-like weights, scaled so that Σᵢ sᵢ·Δᵢ is of the order of w;
        # every third row weighs 0 and must stay inert
        sw = torch.rand(m, device=dev, generator=g) / m ** 0.5
        sw[1::3] = 0.0
        return sw

    def close(name, got, want):
        """Max abs error, and whether every leaf is within tolerance."""
        return leaves_close(torch, got, want,
                            TOLS["bf16" if want[0].dtype == bf16 else name])

    def run_case(name, label, ws, ds, extra):
        """One shape: a list of leaves.  Each kernel goes through its tree
        front, the main path's entry point (one launch per tree)."""
        foreach = None
        others = [ds]
        if name == "apply_scaled":
            s = extra
            kern = lambda: ops.apply_delta_tree(ws, ds, s, mode="kernel")  # noqa
            plain = lambda: ops.apply_delta_tree(ws, ds, s,  # noqa: E731
                                                 mode="ref")
            lib = lambda: [torch.add(w, d, alpha=-s)  # noqa: E731
                           for w, d in zip(ws, ds)]
            if all(w.dtype == d.dtype for w, d in zip(ws, ds)):
                # the one PyTorch call over the whole tree
                foreach = lambda: torch._foreach_add(ws, ds, alpha=-s)  # noqa
            nbytes = sum(2 * w.numel() * w.element_size()
                         + d.numel() * d.element_size()
                         for w, d in zip(ws, ds))
        elif name == "apply_rows_q":
            sw, scs = extra
            others.append(scs)
            kern = lambda: ops.apply_rows_q_tree(  # noqa: E731
                ws, ds, scs, sw, mode="kernel")
            plain = lambda: ops.apply_rows_q_tree(  # noqa: E731
                ws, ds, scs, sw, mode="ref")
            # no PyTorch call takes an int8 stack with row scales: addmv
            # over a dequantized f32 stack is another input, not this one
            lib = None
            # each leaf's stack and scales, w read and out written; the
            # weights are read once for the whole tree
            nbytes = 4 * sw.numel() + sum(
                q.numel() + 2 * w.numel() * w.element_size() + 4 * sc.numel()
                for w, q, sc in zip(ws, ds, scs))
        else:
            sw = extra
            swl = sw.to(ws[0].dtype)
            kern = lambda: ops.apply_rows_tree(ws, ds, sw, mode="kernel")  # noqa
            plain = lambda: ops.apply_rows_tree(ws, ds, sw,  # noqa: E731
                                                mode="ref")
            # addmv takes one dtype: no single library call for mixed types
            lib = None if ds[0].dtype != ws[0].dtype else (
                lambda: [torch.addmv(w.view(-1), d.view(d.shape[0], -1).t(),
                                     swl, alpha=-1) for w, d in zip(ws, ds)])
            # the weights are read once for the whole tree
            nbytes = 4 * sw.numel() + sum(
                2 * w.numel() * w.element_size() + d.numel() * d.element_size()
                for w, d in zip(ws, ds))
        want = plain()
        # A kernel that left an output element unwritten (a ragged tail)
        # would hand back what the allocator's block held before: make that
        # NaN, which no check passes.  With the cache emptied first, the
        # wrapper's torch.empty gets the blocks just freed, since it asks
        # for the same sizes on the same stream.
        torch.cuda.empty_cache()
        poison = [torch.full_like(w, float("nan")) for w in ws]
        del poison
        planned = planned_launches(K, ws, *others)
        K.reset_launches()
        got = kern()
        launched = K.LAUNCHES[name]
        torch.cuda.synchronize()
        check(launched == planned, f"{name} {label}: {launched} launches, "
                                   f"{planned} planned")
        err, ok = close(name, got, want)
        check(ok, f"{name} {label}: kernel disagrees with its plain version "
                  f"(max abs err {err})")
        # the check must reject a kernel that returns w unchanged, and one
        # that adds the update instead of subtracting it
        noop_err, noop_ok = close(name, ws, want)
        flipped = [(2 * w.float() - o.float()).to(w.dtype)
                   for w, o in zip(ws, want)]
        flip_err, flip_ok = close(name, flipped, want)
        check(not noop_ok and not flip_ok,
              f"{name} {label}: the tolerance cannot tell a no-op "
              f"(err {noop_err}) or a sign flip (err {flip_err}) from the "
              f"plain version")
        if name in ("apply_rows", "apply_rows_q"):
            # the rows are summed in a fixed order: a second call gives the
            # same bits
            again = kern()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {label}: two calls on the same inputs differ")
            del again
        del got, want, flipped
        t = time_interleaved(torch, {"ms": kern, "plain_ms": plain,
                                     "library_ms": lib,
                                     "foreach_ms": foreach})
        row = {"shape": label, "max_abs_err": err,
               "noop_err": noop_err, "sign_flip_err": flip_err,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": t["library_ms"],
               "launches_per_call": planned}
        if name == "apply_scaled":
            row["foreach_ms"] = t["foreach_ms"]
        results[name].append(row)
        print(f"kernel {name} {label}: {json.dumps(row)}", flush=True)
        return row

    dtypes = {"f32": f32, "bf16": bf16}

    def dname(dw, dd):
        return dw if dw == dd else f"w {dw} d {dd}"

    # the main path's shapes: the MNIST CNN's 8 leaves, one launch
    ws = [randn(*sh, scale=0.5) for sh in cnn_shapes]
    ds = [randn(*sh, scale=0.5) for sh in cnn_shapes]
    row = run_case("apply_scaled", "MNIST_CNN 8 leaves f32", ws, ds, 0.7)
    # the front's outputs: one torch.empty_like per leaf, against one flat
    # buffer cut into leaf views (each view's offset rounded up to 16 bytes)
    sizes = [w.numel() for w in ws]
    padded = [-(-n // 4) * 4 for n in sizes]

    def flat_views():
        flat = torch.empty(sum(padded), device=dev)
        return [v[:n].view(w.shape) for v, n, w
                in zip(flat.split(padded), sizes, ws)]
    t = time_interleaved(torch, {
        "alloc_ms": lambda: [torch.empty_like(w) for w in ws],
        "flat_alloc_ms": flat_views, "front_ms": lambda: ops.apply_delta_tree(
            ws, ds, 0.7, mode="kernel")})
    row.update(alloc_ms=t["alloc_ms"], flat_alloc_ms=t["flat_alloc_ms"])
    print(f"kernel apply_scaled MNIST_CNN outputs: per-leaf empty_like "
          f"{row['alloc_ms']:.5f} ms, one flat buffer with leaf views "
          f"{row['flat_alloc_ms']:.5f} ms, the front {t['front_ms']:.5f} ms",
          flush=True)
    row["host_us"] = front_host_breakdown(torch, K, ops, ws, ds, 0.7)
    print(f"kernel apply_scaled MNIST_CNN front, host us per call: "
          f"{json.dumps(row['host_us'])}", flush=True)
    for m in (8, 16, 64):
        stacks = [randn(m, *sh) for sh in cnn_shapes]
        run_case("apply_rows", f"MNIST_CNN 8 leaves M={m} f32", ws, stacks,
                 row_weights(m))
    del ws, ds, stacks
    for n, dw, dd in SCALED_CASES:
        w = randn(n, scale=0.5, dtype=dtypes[dw])
        d = randn(n, scale=0.5, dtype=dtypes[dd])
        run_case("apply_scaled", f"n={n} {dname(dw, dd)}", [w], [d], 0.7)
        del w, d
    for m, n, dw, dd in ROWS_CASES:
        w = randn(n, scale=0.5, dtype=dtypes[dw])
        d = randn(m, n, dtype=dtypes[dd])
        sw = row_weights(m)
        if m > 1024:
            # a run of zero-weight rows
            sw[1018:1030] = 0.0
        run_case("apply_rows", f"M={m} n={n} {dname(dw, dd)}", [w], [d], sw)
        del w, d

    def q_inputs(m, shapes):
        # int8 codes over the full range, each leaf's own scales of order
        # 1/127 (a QuantStack's) and weights rand/sqrt(M), so the update is
        # of the order of w; every third row is a padding row (weight 0,
        # scale 0) and must stay inert
        qs = [torch.randint(-127, 128, (m, *sh), device=dev, generator=g,
                            dtype=torch.int8) for sh in shapes]
        scs = [(0.5 + torch.rand(m, device=dev, generator=g)) / 127.0
               for _ in shapes]
        sw = row_weights(m)
        for sc in scs:
            sc[1::3] = 0.0
        if m > 1024:
            sw[1018:1030] = 0.0
            for sc in scs:
                sc[1018:1030] = 0.0
        return qs, (sw, scs)

    qs, extra = q_inputs(32, cnn_shapes)
    ws = [randn(*sh, scale=0.5) for sh in cnn_shapes]
    run_case("apply_rows_q", "MNIST_CNN 8 leaves M=32 f32", ws, qs, extra)
    del ws, qs
    for m, n, dw in ROWS_Q_CASES:
        w = randn(n, scale=0.5, dtype=dtypes[dw])
        qs, extra = q_inputs(m, [(n,)])
        run_case("apply_rows_q", f"M={m} n={n} {dw}", [w], qs, extra)
        del w, qs
    for lm_label, lm_shapes in lm_cases:
        # the window apply of phases (f) and (i): an LM's personal leaves
        # at M = 4 (4 users, one pow2 bucket), one launch per tree
        ws = [randn(*sh, scale=0.5) for sh in lm_shapes]
        stacks = [randn(4, *sh) for sh in lm_shapes]
        run_case("apply_rows", f"{lm_label} M=4 f32", ws, stacks,
                 row_weights(4))
        del stacks
        qs, extra = q_inputs(4, lm_shapes)
        run_case("apply_rows_q", f"{lm_label} M=4 w f32", ws, qs, extra)
        del ws, qs
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return results


def local_step_phase(torch, cnn_shapes, lm_cases):
    """``sgd_step``, ``prox_inner`` and ``prox_outer`` through their tree
    fronts, the entry points that run them: ``ops.<name>_tree(mode=
    "kernel")`` against ``mode="ref"`` on the same inputs, at the MNIST
    CNN's leaves, at LOCAL_CASES and at the LMs' full param trees.  The
    counts are zeroed just before each front's checked call and read just
    after; their sum is the kernels line's ``launches``.  Returns the rows
    per kernel and those sums."""
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops

    g = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    results = {name: [] for name in LOCAL_STEPS}
    launches = dict.fromkeys(LOCAL_STEPS, 0)

    def randn(shape, scale, dtype):
        return (scale * torch.randn(*shape, device="cuda", generator=g)
                ).to(dtype)

    def operands(name, shapes, first, other):
        """The front's tensor trees, the output's template first: (w, g),
        (θ, g, w) or (w, θ); ``other`` is every other tree's dtype."""
        g_scale = LOCAL_STEPS[name][1]
        trees = [[randn(sh, 0.5, first) for sh in shapes]]
        if g_scale is not None:
            trees.append([randn(sh, 0.5 * g_scale, other) for sh in shapes])
        if name != "sgd_step":
            trees.append([randn(sh, 0.5, other) for sh in shapes])
        return trees

    def library(name, trees, kw):
        """One PyTorch call per leaf computing the same function, where
        one exists: torch.add promotes a bf16 g to w's f32, torch.lerp
        takes one dtype."""
        same = trees[0][0].dtype == trees[1][0].dtype
        if name == "sgd_step":
            return lambda: [torch.add(w, gg, alpha=-kw["eta"])
                            for w, gg in zip(*trees)]
        if name == "prox_outer" and same:
            return lambda: [torch.lerp(w, t, kw["eta"] * kw["lam"])
                            for w, t in zip(*trees)]
        return None

    def foreach(name, trees, kw):
        """The one PyTorch call over the whole tree, for sgd_step's and
        prox_outer's trees of one dtype."""
        if trees[0][0].dtype != trees[1][0].dtype:
            return None
        if name == "sgd_step":
            return lambda: torch._foreach_add(trees[0], trees[1],
                                              alpha=-kw["eta"])
        if name == "prox_outer":
            return lambda: torch._foreach_lerp(trees[0], trees[1],
                                               kw["eta"] * kw["lam"])
        return None

    def run_case(name, label, shapes, first, other):
        kw = LOCAL_STEPS[name][0]
        front = getattr(ops, name + "_tree")
        trees = operands(name, shapes, dtypes[first], dtypes[other])
        want = front(*trees, **kw, mode="ref")
        # an output element the kernel left unwritten would hold what the
        # allocator's block held before: NaN, which no check passes
        torch.cuda.empty_cache()
        poison = [torch.full_like(x, float("nan")) for x in trees[0]]
        del poison
        planned = planned_launches(K, *trees)
        K.reset_launches()
        got = front(*trees, **kw, mode="kernel")
        n = K.LAUNCHES[name]
        torch.cuda.synchronize()
        check(n == planned, f"{name} {label}: {n} launches through "
                            f"{name}_tree for {len(shapes)} leaves, "
                            f"{planned} planned")
        launches[name] += n
        tol = TOLS["bf16" if dtypes[first] == torch.bfloat16 else name]
        err, ok = leaves_close(torch, got, want, tol)
        check(ok, f"{name} {label}: kernel disagrees with its plain version "
                  f"(max abs err {err})")
        flipped = [(2 * x.float() - o.float()).to(x.dtype)
                   for x, o in zip(trees[0], want)]
        noop_err, noop_ok = leaves_close(torch, trees[0], want, tol)
        flip_err, flip_ok = leaves_close(torch, flipped, want, tol)
        check(not noop_ok and not flip_ok,
              f"{name} {label}: the tolerance cannot tell a no-op (err "
              f"{noop_err}) or a sign flip (err {flip_err}) from the plain "
              f"version")
        del got, want, flipped
        numel = sum(x.numel() for x in trees[0])
        # each input read once and the output written once
        nbytes = sum(x.numel() * x.element_size()
                     for tree in trees for x in tree) \
            + sum(x.numel() * x.element_size() for x in trees[0])
        calls = 20 if numel < 10 ** 8 else 5
        lib, each = library(name, trees, kw), foreach(name, trees, kw)
        t = time_interleaved(torch, {
            "ms": lambda: front(*trees, **kw, mode="kernel"),
            "plain_ms": lambda: front(*trees, **kw, mode="ref"),
            "library_ms": lib, "foreach_ms": each}, calls)
        row = {"shape": label, "max_abs_err": err, "noop_err": noop_err,
               "sign_flip_err": flip_err, "ms": t["ms"],
               "plain_ms": t["plain_ms"],
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "library_ms": t["library_ms"],
               "launches_per_call": planned, "params": numel}
        if name in ("sgd_step", "prox_outer"):
            row["foreach_ms"] = t["foreach_ms"]
        results[name].append(row)
        print(f"kernel {name} {label}: {json.dumps(row)}", flush=True)
        del trees
        torch.cuda.empty_cache()

    cases = [("MNIST_CNN 8 leaves f32", cnn_shapes, "f32", "f32")]
    cases += [(f"n={n} {dw}" if dw == do else f"n={n} first {dw} rest {do}",
               [(n,)], dw, do) for n, dw, do in LOCAL_CASES]
    cases += [(label, shapes, "f32", "f32") for label, shapes in lm_cases]
    for label, shapes, first, other in cases:
        for name in LOCAL_STEPS:
            run_case(name, label, shapes, first, other)
    print(f"local steps through their tree fronts, launches: "
          f"{json.dumps(launches)}", flush=True)
    return results, launches


# trees that probe the leaf table: leaves of these sizes (none, one, less
# than, exactly and more than a thread's 8 elements, the MNIST CNN's last
# bias, whose f32 rows are 40 bytes, and 512 tiles of 2048 and a ragged
# tail), then two leaves of VIEW_N elements (3 tiles and a tail) with w,
# then the other operands, a view 4 bytes into its buffer (no 16-byte
# vectors there), and one leaf of MIXED_N elements whose other operands
# have the other dtype: two launches; and a tree of 3 * max_leaves + 1
# leaves, four.  apply_rows takes them with stacks of TABLE_ROWS rows (the
# long tree with LONG_ROWS): none, one, and 1100 with a run of zero-weight
# rows (1018-1029); apply_rows_q with int8 stacks
# of those rows (the second VIEW_N leaf's a view 3 bytes in, so that no row
# starts on a word) and each leaf's own scales (the first VIEW_N leaf's a
# view 4 bytes in), w of one dtype: one launch, and four on the long tree
TABLE_SIZES = (0, 1, 7, 8, 9, 10, 2 ** 20 + 5)
VIEW_N, MIXED_N = 3 * 2048 + 5, 2 ** 16 + 3
TABLE_ROWS, LONG_ROWS = (0, 1, 1100), 8


def table_tree_phase(torch):
    """The leaf-table kernels through their tree fronts (``mode="kernel"``
    against ``mode="ref"``) on the trees of TABLE_SIZES and on a tree of
    ``3 * max_leaves() + 1`` leaves, f32 and bf16, outputs NaN-poisoned
    first: the planned launches, error 0 for the elementwise kernels and
    ``apply_rows``/``apply_rows_q`` within TOLS with two calls bit-equal,
    and a no-op and a sign flip rejected (for M = 0, the stacked applies
    must give w).  Returns rows per kernel."""
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops

    g = torch.Generator(device="cuda").manual_seed(2)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    eta = LOCAL_STEPS["sgd_step"][0]["eta"]
    po = LOCAL_STEPS["prox_outer"][0]
    pi = LOCAL_STEPS["prox_inner"][0]
    # front(ws, other trees, mode), and the scale of each other operand (an
    # update of the order of w)
    fronts = {"apply_scaled": (lambda ws, o, mode: ops.apply_delta_tree(
                  ws, o[0], 0.7, mode=mode), (0.5,)),
              "sgd_step": (lambda ws, o, mode: ops.sgd_step_tree(
                  ws, o[0], eta, mode=mode),
                  (0.5 * LOCAL_STEPS["sgd_step"][1],)),
              "prox_outer": (lambda ws, o, mode: ops.prox_outer_tree(
                  ws, o[0], po["eta"], po["lam"], mode=mode), (0.5,)),
              "prox_inner": (lambda ws, o, mode: ops.prox_inner_tree(
                  ws, o[0], o[1], pi["eta_in"], pi["lam"], mode=mode),
                  (0.5 * LOCAL_STEPS["prox_inner"][1], 0.5))}
    rows = {name: [] for name in TABLE_KERNELS}

    def randn(n, scale, dtype, offset_bytes=0):
        """n elements; with ``offset_bytes`` a view that far into a buffer."""
        off = offset_bytes // torch.empty((), dtype=dtype).element_size()
        x = (scale * torch.randn(n + off, device="cuda", generator=g)
             ).to(dtype)
        return x[off:]

    def row_weights(m):
        # zero-weight rows: every third, and a run of them
        sw = (0.5 + torch.rand(m, device="cuda", generator=g)) / \
            max(m, 1) ** 0.5
        sw[1::3] = 0.0
        sw[1018:1030] = 0.0
        return sw

    def codes(m, n, offset_bytes=0):
        """An int8 [m, n] stack over the full range; with ``offset_bytes``
        a view that far into a buffer."""
        x = torch.randint(-127, 128, (m * n + offset_bytes,), device="cuda",
                          generator=g, dtype=torch.int8)
        return x[offset_bytes:].view(m, n)

    def row_scales(m, offset_bytes=0):
        """A leaf's [m] scales of order 1/127, zero where the weights'
        padding rows are; with ``offset_bytes`` a view into a buffer."""
        sc = randn(m, 1.0, torch.float32, offset_bytes).abs_().add_(0.5) \
            .div_(127.0)
        sc[1::3] = 0.0
        sc[1018:1030] = 0.0
        return sc

    def awkward(first, other, scales, m=None):
        """The awkward tree and its other operands, one tree per scale;
        with ``m`` the one other operand is the [m, n] stacks."""
        def operand(n, dtype, scale, offset_bytes=0):
            if m is None:
                return randn(n, scale, dtype, offset_bytes)
            return randn(m * n, scale, dtype, offset_bytes).view(m, n)
        ws = [randn(n, 0.5, first) for n in TABLE_SIZES]
        ws += [randn(VIEW_N, 0.5, first, 4), randn(VIEW_N, 0.5, first),
               randn(MIXED_N, 0.5, first)]
        others = []
        for scale in scales:
            bs = [operand(n, first, scale) for n in TABLE_SIZES]
            bs += [operand(VIEW_N, first, scale),
                   operand(VIEW_N, first, scale, 4),
                   operand(MIXED_N, other, scale)]
            # (an M = 0 stack holds nothing to misalign)
            check(ws[-3].data_ptr() % 16 == 4
                  and (bs[-2].data_ptr() % 16 == 4 or not bs[-2].numel()),
                  "table trees: the views do not sit 4 bytes past 16")
            others.append(bs)
        return ws, others

    def q_awkward(first, m):
        """The awkward tree for apply_rows_q: w, int8 stacks, scales."""
        sizes = TABLE_SIZES + (VIEW_N, VIEW_N, MIXED_N)
        view = len(TABLE_SIZES)
        ws = [randn(n, 0.5, first, 4 if i == view else 0)
              for i, n in enumerate(sizes)]
        qs = [codes(m, n, 3 if i == view + 1 else 0)
              for i, n in enumerate(sizes)]
        scs = [row_scales(m, 4 if i == view else 0)
               for i in range(len(sizes))]
        check(ws[view].data_ptr() % 16 == 4
              and (qs[view + 1].data_ptr() % 16 == 3 or not m),
              "table trees: the views do not sit 4 and 3 bytes past 16")
        return ws, [qs, scs]

    def long_tree(first, scales, m=None):
        sizes = [1 + (i * 997) % 5000 for i in range(3 * K.max_leaves() + 1)]
        lead = () if m is None else (m,)
        return ([randn(n, 0.5, first) for n in sizes],
                [[randn(m * n if m else n, scale, first).view(*lead, n)
                  for n in sizes] for scale in scales])

    def q_long_tree(first, m):
        ws, _ = long_tree(first, ())
        return ws, [[codes(m, w.numel()) for w in ws],
                    [row_scales(m) for _ in ws]]

    def run(name, label, front, ws, others, tol):
        want = front(ws, others, "ref")
        torch.cuda.empty_cache()
        poison = [torch.full_like(w, float("nan")) for w in ws]
        del poison
        planned = planned_launches(K, ws, *others)
        K.reset_launches()
        got = front(ws, others, "kernel")
        launched = K.LAUNCHES[name]
        torch.cuda.synchronize()
        check(launched == planned, f"{name} {label}: {launched} "
                                   f"launches, {planned} planned")
        err, ok = leaves_close(torch, got, want, tol)
        stacked = name in ("apply_rows", "apply_rows_q")
        check(ok and (err == 0.0 or stacked),
              f"{name} {label}: kernel differs from its plain version (max "
              f"abs err {err})")
        row = {"shape": label, "max_abs_err": err,
               "launches_per_call": launched, "leaves": len(ws)}
        if stacked:
            again = front(ws, others, "kernel")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{name} {label}: two calls on the same inputs differ")
            row["two_calls_bit_equal"] = True
            del again
        if stacked and others[0][0].shape[0] == 0:
            # no rows: the output is w, bit for bit
            check(all(torch.equal(a, w) for a, w in zip(got, ws)),
                  f"{name} {label}: M = 0 does not give w")
        else:
            flipped = [(2 * w.float() - o.float()).to(w.dtype)
                       for w, o in zip(ws, want)]
            noop_err, noop_ok = leaves_close(torch, ws, want, tol)
            flip_err, flip_ok = leaves_close(torch, flipped, want, tol)
            check(not noop_ok and not flip_ok,
                  f"{name} {label}: the tolerance cannot tell a no-op (err "
                  f"{noop_err}) or a sign flip (err {flip_err}) from the "
                  f"plain version")
            row.update(noop_err=noop_err, sign_flip_err=flip_err)
        rows[name].append(row)
        print(f"kernel {name} {label}: {json.dumps(row)}", flush=True)

    for dn, first in dtypes.items():
        other = dtypes["bf16" if dn == "f32" else "f32"]
        tol = TOLS["bf16" if first == torch.bfloat16 else "apply_scaled"]
        awkward_label = (f"table tree {dn} (sizes {list(TABLE_SIZES)}, 2 "
                         f"views 4 bytes in, 1 mixed leaf)")
        long_label = f"table tree {dn} {3 * K.max_leaves() + 1} leaves"
        for name, (front, scales) in fronts.items():
            run(name, awkward_label, front, *awkward(first, other, scales),
                tol)
            run(name, long_label, front, *long_tree(first, scales), tol)
        # (label, M, whether the long tree); apply_rows_q's awkward tree has
        # no mixed leaf (its stacks are int8, its w of one dtype)
        q_label = (f"table tree {dn} (sizes {list(TABLE_SIZES)}, w and "
                   f"scales views 4 bytes in, a stack view 3 bytes in)")
        for name in ("apply_rows", "apply_rows_q"):
            rtol = TOLS["bf16" if first == torch.bfloat16 else name]
            label0 = awkward_label if name == "apply_rows" else q_label
            stacks = [(f"{label0} M={m}", m, False) for m in TABLE_ROWS]
            stacks.append((f"{long_label} M={LONG_ROWS}", LONG_ROWS, True))
            for label, m, long in stacks:
                sw = row_weights(m)
                if name == "apply_rows":
                    front = lambda ws, o, mode: ops.apply_rows_tree(  # noqa
                        ws, o[0], sw, mode=mode)
                    trees = long_tree(first, (1.0,), m) if long \
                        else awkward(first, other, (1.0,), m)
                else:
                    front = lambda ws, o, mode: ops.apply_rows_q_tree(  # noqa
                        ws, o[0], o[1], sw, mode=mode)
                    trees = q_long_tree(first, m) if long \
                        else q_awkward(first, m)
                run(name, label, front, *trees, rtol)
                del trees
        torch.cuda.empty_cache()
    return rows


# ssd_fwd against ssd_ref on the card, as the reference's own
# test_ssd_kernel_matches_sequential_ref: the kernel sums the chunk products
# in another order than the sequential recurrence
SSD_TOL = dict(atol=5e-4, rtol=5e-4)
# chunk invariance of the kernel (1e-4, as the reference's
# test_ssd_chunk_invariance)
SSD_CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)
# the card's peak rate for the operands' type (NVIDIA's data sheet, H100
# SXM, dense): bf16 operands can run on the tensor cores with f32
# accumulation and lose nothing against f32 FMAs on widened bf16, so the
# bound of a bf16 case is taken at the bf16 tensor-core rate; the f32
# CUDA-core rate, the ceiling of a design that multiplies on the CUDA cores,
# is reported beside it
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 tensor cores


def bound_fields(torch, dtype, nbytes, flops, ms):
    """``bound_ms`` / ``bound_by`` at the peak rate for ``dtype``, the f32
    CUDA-core bound beside it, and the share of each that ``ms`` reaches."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_f = flops / peak * 1e3
    t_f32 = flops / F32_FLOPS_PER_S * 1e3
    bound = max(t_b, t_f)
    return {"bound_ms": bound,
            "bound_by": "bytes" if t_b > t_f else "operations",
            "bound_share": bound / ms,
            "f32_cuda_core_bound_ms": max(t_b, t_f32),
            "f32_cuda_core_share": max(t_b, t_f32) / ms,
            "bytes": nbytes, "flops": flops}
# (B, S) at mamba2-130m's H 24, P 64, G 1, N 128, chunk 128: the
# personalization cohort folded into the batch (4 users x 128 tokens), the
# prefill of phase (g) at (8, 4096), and prefill_32k's length at batch 1
SSD_CASES = ((4, 128), (8, 4096), (1, 32768))
# per-row a_log (rows, H), (B, S, input dtype): what the vmap rule of
# models/mamba2.py hands the kernel once every user of a cohort carries their
# own params, as in (f) from the first prox step on; at the (f) cohort shape
# and at one long shape
SSD_ROW_CASES = ((4, 128, "f32"), (4, 128, "bf16"), (8, 4096, "bf16"))
SSD_DIMS = dict(H=24, P=64, G=1, N=128, chunk=128)
SSD_MAIN_SHAPE = "B=4 S=128 bf16 a_log (B,H)"
# zamba2-1.2b's scan (H 64, P 64, G 1, N 64: 4 state entries a thread, not
# 8), bf16, per-row a_log, at (i)'s cohort (4 users x 128 tokens) and (j)'s
# (8, 4096)
SSD_ZAMBA_DIMS = dict(H=64, P=64, G=1, N=64, chunk=128)
SSD_ZAMBA_CASES = ((4, 128), (8, 4096))
# mamba2-130m's dims in two groups of 12 heads, and at chunk 64, bf16 at
# (2, 1024): each block walks heads of one group, and a chunk of 64 takes
# half of each 128-token tile
SSD_GROUP_CASES = ((2, 1024, dict(SSD_DIMS, G=2), " G=2"),
                   (2, 1024, dict(SSD_DIMS, chunk=64), " chunk=64"))
# (T2)'s training shape: mamba2-130m's scan at the driver's (8, 512), bf16,
# its one (H,) a_log
SSD_TRAIN_CASES = ((8, 512),)


def ssd_inputs(torch, g, B, S, dtype, per_row=False, dims=SSD_DIMS):
    """Inputs at ``dims`` on the card, scaled so that |y| is of order 1: dt
    as the model's softplus, a_log as mamba2's init (A from -1 to -16), B
    and C with C.B of order 1.  ``per_row`` gives a_log as (B, H), row b
    the init rolled by 5b heads, so that no two rows agree."""
    H, P, G, N = (dims[k] for k in "HPGN")
    dev = "cuda"
    x = torch.randn(B, S, H, P, device=dev, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, device=dev, generator=g) - 1.0)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    if per_row:
        a_log = torch.stack([a_log.roll(5 * b) for b in range(B)])
    bm = (torch.randn(B, S, G, N, device=dev, generator=g)
          / N ** 0.25).to(dtype)
    cm = (torch.randn(B, S, G, N, device=dev, generator=g)
          / N ** 0.25).to(dtype)
    return x, dt, a_log, bm, cm


def ssd_cost(B, S, H, P, G, N, chunk, x_bytes, alog_rows=1):
    """(bytes, FLOPs) the scan must move and do: inputs read once and y (f32)
    written once; per (chunk, head) 2l^2 N + 2l^2 P + 4lNP FLOPs."""
    nbytes = (B * S * H * P * (x_bytes + 4) + B * S * H * 4
              + alog_rows * H * 4 + 2 * B * S * G * N * x_bytes)
    flops = (S // chunk) * B * H * (2 * chunk ** 2 * N + 2 * chunk ** 2 * P
                                    + 4 * chunk * N * P)
    return nbytes, flops


def ssd_kernel_phase(torch):
    """ssd_fwd against ssd_ref on the card at SSD_CASES, f32 and bf16 x/B/C
    (f32 dt), with a shared (H,) a_log, and at SSD_ROW_CASES with a per-row
    (B, H) one, within SSD_TOL; a zero and a sign-flipped output must fail
    the same check, and with per-row a_log so must the output of a kernel
    that read row 0 for every row; chunk invariance at (1, 1024).  The
    same at zamba2's dims (SSD_ZAMBA_DIMS, SSD_ZAMBA_CASES, bf16, per-row
    a_log) and at SSD_GROUP_CASES (G = 2, chunk 64).  Every case is also
    held within SSD_TOL against ``ssd_phases_ref``, the plain model of the
    kernels' three phases and their hi/lo bf16 split, and must launch the
    kernels ``kernel.plan`` names (3, or 1 for a one-chunk sequence)."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd.ref import ssd_phases_ref, ssd_ref
    g = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(B, S, d, False, SSD_DIMS, "") for B, S in SSD_CASES
             for d in dtypes]
    cases += [(B, S, d, True, SSD_DIMS, "") for B, S, d in SSD_ROW_CASES]
    cases += [(B, S, "bf16", True, SSD_ZAMBA_DIMS, " zamba2 H=64 N=64")
              for B, S in SSD_ZAMBA_CASES]
    cases += [(B, S, "bf16", False, dims, tag)
              for B, S, dims, tag in SSD_GROUP_CASES]
    cases += [(B, S, "bf16", False, SSD_DIMS, " mamba2-130m (T2)")
              for B, S in SSD_TRAIN_CASES]
    rows = []
    for B, S, dname, per_row, dims, tag in cases:
        ins = ssd_inputs(torch, g, B, S, dtypes[dname], per_row, dims)
        label = (f"B={B} S={S} {dname}" + (" a_log (B,H)" if per_row
                                            else "") + tag)
        want = ssd_ref(*ins)
        torch.cuda.empty_cache()
        poison = torch.full_like(want, float("nan"))
        del poison
        K.reset_launches()
        got = K.ssd_fwd(*ins, chunk=dims["chunk"])
        torch.cuda.synchronize()
        launched = dict(K.LAUNCHES)
        pl = K.plan(B, S, dims["H"], dims["P"], dims["G"], dims["N"],
                    dims["chunk"], ins[0].element_size())
        check(launched == {"ssd_fwd": 1, "ssd_fwd_kernels": pl.kernels},
              f"ssd_fwd {label}: launched {launched}, expected one call "
              f"of {pl.kernels} kernels")
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, want, **SSD_TOL),
              f"ssd_fwd {label}: kernel disagrees with ssd_ref (max abs "
              f"err {err})")
        model = ssd_phases_ref(*ins, chunk=dims["chunk"])
        model_err = float((got - model).abs().max())
        model_ref_err = float((model - want).abs().max())
        check(torch.allclose(got, model, **SSD_TOL),
              f"ssd_fwd {label}: kernel disagrees with ssd_phases_ref (max "
              f"abs err {model_err})")
        del model
        zero_ok = torch.allclose(torch.zeros_like(want), want, **SSD_TOL)
        flip_ok = torch.allclose(-want, want, **SSD_TOL)
        check(not zero_ok and not flip_ok,
              f"ssd_fwd {label}: the tolerance cannot tell a zero or a "
              f"sign-flipped output from ssd_ref")
        row0_err = None
        if per_row:
            # what a kernel that ignored a_log's row stride would give
            row0 = ssd_ref(ins[0], ins[1], ins[2][0], *ins[3:])
            row0_err = float((row0 - want).abs().max())
            check(not torch.allclose(row0, want, **SSD_TOL),
                  f"ssd_fwd {label}: the tolerance cannot tell row 0's "
                  f"a_log used for every row from ssd_ref")
            del row0
        y_abs = float(want.abs().mean())
        check(0.05 < y_abs < 20.0, f"ssd_fwd {label}: inputs give mean "
                                   f"|y| {y_abs}, not of order 1")
        nbytes, flops = ssd_cost(B, S, x_bytes=ins[0].element_size(),
                                 alog_rows=B if per_row else 1, **dims)
        big = B * S >= 32768
        row = {"shape": label, "max_abs_err": err,
               "model_err": model_err, "model_vs_ssd_ref": model_ref_err,
               "zero_err": float(want.abs().max()),
               "row0_a_log_err": row0_err,
               "mean_abs_y": y_abs,
               "ms": time_ms(torch, lambda: K.ssd_fwd(
                   *ins, chunk=dims["chunk"]),
                   launches=5 if big else 20),
               "plain_ms": time_ms(torch, lambda: ssd_ref(*ins),
                                   launches=1, repeats=1,
                                   warmup=0 if big else 1),
               # no single PyTorch call computes the scan
               "library_ms": None,
               "kernels_per_call": launched["ssd_fwd_kernels"],
               "heads_per_block": pl.heads_per_block,
               "scratch_bytes": pl.scratch_bytes,
               # the bytes the three kernels move (the states' four passes
               # and the second read of the inputs included), over 3.35 TB/s
               "design_bytes": pl.design_bytes,
               "design_bound_ms": pl.design_bytes / HBM_BYTES_PER_S * 1e3}
        row.update(bound_fields(torch, ins[0].dtype, nbytes, flops,
                                row["ms"]))
        rows.append(row)
        print(f"kernel ssd_fwd {label}: {json.dumps(row)}", flush=True)
        del ins, want, got
    # chunk invariance: the kernel at chunk 32, 64 and 128 on one input
    ins = ssd_inputs(torch, g, 1, 1024, torch.float32)
    outs = {c: K.ssd_fwd(*ins, chunk=c) for c in (32, 64, 128)}
    inv = max(float((outs[c] - outs[128]).abs().max()) for c in (32, 64))
    check(all(torch.allclose(outs[c], outs[128], **SSD_CHUNK_TOL)
              for c in (32, 64)),
          f"ssd_fwd: chunk 32/64/128 disagree by {inv}")
    print(f"kernel ssd_fwd chunk invariance (1, 1024) chunk 32/64/128: max "
          f"abs diff {inv:.3e} (tol {SSD_CHUNK_TOL})", flush=True)
    torch.cuda.empty_cache()
    return rows


# flash_attention_fwd against attention_ref on the card, as the reference's
# own tests (tests/test_kernels.py:31-43): 2e-5 in f32 (the kernel sums q.k
# and p.v in another order), 2e-2 in bf16 (the reference forms q.k in bf16
# and rounds the probabilities to bf16; the kernel keeps both in f32)
FLASH_TOL = {"f32": dict(atol=2e-5, rtol=2e-5),
             "bf16": dict(atol=2e-2, rtol=2e-2)}
# (B, S, Hq, Hkv, hd, dtype, window, softcap): (i)'s cohort (4 users x 128
# tokens, zamba2's heads, its 4096 window wider than the stream); (j)'s
# (2, 4096) in f32 and bf16 with a 1024 window; gemma2-like hd 256, GQA
# 2:1, with gemma2's softcap 50 in f32, windowed and not, and a softcap of
# 5 in bf16; MQA; a tail (S not a multiple of the 64-row tile) with GQA
# 4:1; and prefill_32k's length at batch 1.  Every softcap case must tell
# the output without the softcap from the plain version's.  At these
# inputs (logits of std 2 in f32, 1 in bf16) a cap of 50 moves the output
# by about 0.1 in f32, thousands of times FLASH_TOL, but by less than
# FLASH_TOL in bf16; logits large enough for a cap of 50 to bind in bf16
# are ones that the reference's bf16 q.k rounds by more than FLASH_TOL
# (measured on the CPU at (1, 2048, 8, 4, 256)), so the bf16 cases take a
# cap of 5, which moves the output by about 20 x FLASH_TOL.  Then (j)'s own
# prefill shape (8, 4096) with its 4096 window, which is causal attention
# (SDPA's causal call is its library_ms), and bf16 cases for the wgmma
# kernel's other paths: a tail with GQA 4:1 and a window, hd 128 MQA, and
# hd 128 with GQA 4:1, a window and a softcap of 5.  Then gemma2-2b's own
# prefill shapes for the bf16 hd-256 kernel (8/4 heads of 256, the softcap
# of 5 by the rule above): (s)'s (8, 4096) with the 4096 window (causal),
# and (1, 32768) with the window of its local layers and without one, as
# its global layers run it; (r)'s cohort shape (4 users x 128 tokens, the
# window wider than the stream), one partial 8-row tile (2 streams of 8
# tokens), and a tail (S not a multiple of the kernel's 64-row tile) with a
# window.  Then bf16 hd 256 without a softcap and with MQA (8 query heads on
# one kv head): the uncapped branch and Hkv = 1 on the wgmma kernel.  Last,
# granite-moe-1b-a400m's prefill shapes of (v): 16 query heads on 8 kv
# heads of 64, causal with no window, at (8, 4096) and (1, 32768).
FLASH_CASES = (
    (4, 128, 32, 32, 64, "bf16", 4096, 0.0),
    (2, 4096, 32, 32, 64, "f32", 1024, 0.0),
    (2, 4096, 32, 32, 64, "bf16", 1024, 0.0),
    (1, 2048, 8, 4, 256, "f32", 1024, 50.0),
    (1, 2048, 8, 4, 256, "f32", 0, 50.0),
    (1, 2048, 8, 4, 256, "bf16", 1024, 5.0),
    (1, 2048, 8, 4, 256, "bf16", 0, 5.0),
    (1, 1024, 8, 1, 128, "f32", 0, 0.0),
    (1, 1000, 8, 2, 64, "f32", 300, 0.0),
    (1, 32768, 32, 32, 64, "bf16", 4096, 0.0),
    (8, 4096, 32, 32, 64, "bf16", 4096, 0.0),
    (1, 1000, 8, 2, 64, "bf16", 300, 0.0),
    (1, 1024, 8, 1, 128, "bf16", 0, 0.0),
    (1, 2048, 16, 4, 128, "bf16", 512, 5.0),
    (8, 4096, 8, 4, 256, "bf16", 4096, 5.0),
    (1, 32768, 8, 4, 256, "bf16", 4096, 5.0),
    (1, 32768, 8, 4, 256, "bf16", 0, 5.0),
    (4, 128, 8, 4, 256, "bf16", 4096, 5.0),
    (2, 8, 8, 4, 256, "bf16", 4096, 5.0),
    (1, 1000, 8, 4, 256, "bf16", 300, 5.0),
    (1, 2048, 8, 1, 256, "bf16", 0, 0.0),
    (8, 4096, 16, 8, 64, "bf16", 0, 0.0),
    (1, 32768, 16, 8, 64, "bf16", 0, 0.0),
    # (u)'s cohort shape: granite-moe's attention on the 4 users' 128-token
    # streams
    (4, 128, 16, 8, 64, "bf16", 0, 0.0),
    # (T2)'s training shape: granite-moe's attention at the driver's (8, 512)
    (8, 512, 16, 8, 64, "bf16", 0, 0.0),
)
FLASH_MAIN_SHAPE = "B=4 S=128 Hq=32 Hkv=32 hd=64 bf16 window=4096"
# past this length the plain version's logits do not fit: the case is
# checked on its first FLASH_EDGE rows (against the plain version on the
# first FLASH_EDGE positions) and its last FLASH_EDGE rows (against the
# plain version of those rows, placed by ``q_offset``, on the last window +
# FLASH_EDGE keys, which hold their whole windows, or on all keys without a
# window)
FLASH_PLAIN_MAX_S, FLASH_EDGE = 8192, 256
# above this many bytes of f32 logits (B·Hq·S²·4) the plain versions run one
# batch row at a time: attention_ref at (8, 4096, 32 heads) would hold
# several 17 GB tensors at once
FLASH_PLAIN_MAX_LOGITS_BYTES = 2 ** 33


def live_pairs(S, window):
    """(query, key) pairs one head attends: sum over i of min(i + 1, W)."""
    W = min(window, S) if window else S
    return W * (W + 1) // 2 + (S - W) * W


def flash_inputs(torch, g, B, S, Hq, Hkv, hd, dtype):
    """q, k, v on the card.  k unit normal; v unit normal plus t/S along
    the position t, so the output is of order 1 and moves with the window;
    q 2 x unit normal in f32 (a peaked softmax) and unit normal in bf16,
    where the reference's bf16 logits would otherwise move the output by
    up to 1.1 x FLASH_TOL (measured on the CPU at (4096, 1024))."""
    dev = "cuda"
    q_scale = 2.0 if dtype == torch.float32 else 1.0
    q = (q_scale * torch.randn(B, S, Hq, hd, device=dev, generator=g)
         ).to(dtype)
    k = torch.randn(B, S, Hkv, hd, device=dev, generator=g).to(dtype)
    pos = torch.arange(S, device=dev, dtype=torch.float32) / S
    v = (torch.randn(B, S, Hkv, hd, device=dev, generator=g)
         + pos[None, :, None, None]).to(dtype)
    return q, k, v


def sdpa_library(torch, q, k, v, window, long):
    """One ``scaled_dot_product_attention`` call computing the kernel's
    function without a softcap on the same tensors (heads moved to dim 1 as
    views).  A window narrower than S goes in as a boolean mask.  At long
    lengths only the flash and memory-efficient backends are allowed: the
    math fallback would materialize the logits."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    S, Hq, Hkv = q.shape[1], q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(scale=q.shape[-1] ** -0.5, enable_gqa=Hq != Hkv)
    if window and window < S:
        i = torch.arange(S, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) \
            & (i[None, :] > i[:, None] - window)
    else:
        kw["is_causal"] = True
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if not long:
        backends.append(SDPBackend.MATH)

    def call():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)
    return call


def flex_library(torch, q, k, v, window, cap, causal=True):
    """One compiled ``flex_attention`` call computing the kernel's function
    with a softcap, which SDPA does not take: the tanh cap as its
    ``score_mod``, the offset-0 causal mask over (S, T) (narrowed to
    ``window``) as a block mask, none without ``causal``, GQA by
    ``enable_gqa``, heads moved to dim 1 as views.  Returns the call (its
    first call compiles) and the seconds the block mask took."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    global _FLEX
    if _FLEX is None:
        # a fresh score_mod per case recompiles; past dynamo's default
        # limit of 8 it would fall back to the eager version, which
        # materializes the logits
        import torch._dynamo
        torch._dynamo.config.recompile_limit = 64
        _FLEX = torch.compile(flex_attention, dynamic=False)
    S, T, Hq, Hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        live = ki <= qi
        return live & (qi - ki < window) if window else live
    t0 = time.perf_counter()
    mask = create_block_mask(mask_mod, None, None, S, T, device=q.device,
                             _compile=True) if causal else None
    mask_s = time.perf_counter() - t0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(score_mod=score_mod, block_mask=mask,
              scale=q.shape[-1] ** -0.5, enable_gqa=Hq != Hkv)
    return (lambda: _FLEX(qt, kt, vt, **kw)), mask_s


_FLEX = None


def ptxas_report(lib: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of the kernel of library
    ``lib`` whose mangled name holds ``kernel``, from nvcc's ``-Xptxas -v``
    report kept beside the library, and ptxas' warnings that name it
    ("wgmma ... serialized" among them).  None where the report lacks it."""
    from repro_torch.kernels import _build
    out = {"kernel": kernel, "registers": None, "stack_frame": None,
           "spill_stores": None, "spill_loads": None}
    log = _build.library_path(lib).with_suffix(".log")
    lines = log.read_text().splitlines() if log.is_file() else []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or kernel not in line:
            continue
        for nxt in lines[i + 1:i + 6]:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", nxt)
            if m:
                out.update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", nxt)
            if m:
                out["registers"] = int(m[1])
                break
        break
    out["warnings"] = [ln.strip() for ln in lines
                       if "warning" in ln and kernel in ln]
    return out


def flash_kernel_phase(torch):
    """flash_attention_fwd against attention_ref and against
    attention_tiles_ref (the plain model of the kernels' arithmetic, at
    ``K.key_tile``'s tile) on the card at FLASH_CASES within FLASH_TOL; a
    zero and a sign-flipped output must fail the same check, in every
    windowed case (window < S) so must the output without the window, and
    in every softcap case the output without the softcap."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                        attention_tiles_ref)
    g = torch.Generator(device="cuda").manual_seed(3)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = []
    for B, S, Hq, Hkv, hd, dname, window, cap in FLASH_CASES:
        label = (f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} {dname} "
                 f"window={window}" + (f" softcap={cap:g}" if cap else ""))
        q, k, v = flash_inputs(torch, g, B, S, Hq, Hkv, hd, dtypes[dname])
        kw = dict(causal=True, window=window, softcap=cap)
        long = S > FLASH_PLAIN_MAX_S
        torch.cuda.empty_cache()
        poison = torch.full_like(q, float("nan"))
        del poison
        got = K.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"flash_attention_fwd {label}: output not finite")
        windowed = 0 < window < S
        block_k = K.key_tile(q.dtype, hd)
        rowwise = B * Hq * S * S * 4 > FLASH_PLAIN_MAX_LOGITS_BYTES

        def by_rows(fn, **kw2):
            # fn on q, k, v; one batch row at a time where all rows' logits
            # would not fit
            if not rowwise:
                return fn(q, k, v, **kw2)
            return torch.cat([fn(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw2)
                              for b in range(B)])
        if not long:
            def plain():
                return by_rows(attention_ref, **kw)
            pairs = [(got, plain())]
            tile_pairs = [(got, by_rows(attention_tiles_ref, **kw,
                                        block_k=block_k))]
            nowin = [by_rows(attention_ref, causal=True, softcap=cap)] \
                if windowed else []
            # the output without the softcap, and what it must differ from
            nocap = [(by_rows(attention_ref, causal=True, window=window),
                      pairs[-1][1])] if cap else []
            plain_note = "whole case" + (
                f", one batch row at a time ({B} rows)" if rowwise else "")
        else:
            # the last E rows against the last L keys: their whole windows,
            # or every key without a window
            E = FLASH_EDGE
            L = min(S, window + E) if window else S
            # the last L positions start on a key tile, as the kernel's do
            check((S - L) % block_k == 0,
                  f"flash_attention_fwd {label}: the tail check's first "
                  f"position {S - L} is not on a {block_k}-key tile")

            def tail(fn, **kw2):
                return fn(q[:, -E:], k[:, -L:], v[:, -L:], q_offset=L - E,
                          **kw2)

            def plain():
                return tail(attention_ref, **kw)
            head = attention_ref(q[:, :E], k[:, :E], v[:, :E], **kw)
            pairs = [(got[:, :E], head), (got[:, -E:], plain())]
            tile_pairs = [
                (got[:, :E], attention_tiles_ref(
                    q[:, :E], k[:, :E], v[:, :E], **kw, block_k=block_k)),
                (got[:, -E:], tail(attention_tiles_ref, **kw,
                                   block_k=block_k))]
            # the plain version cannot take the whole sequence without the
            # window either: the kernel's own no-window rows stand for it
            nowin = [K.flash_attention_fwd(q, k, v, causal=True,
                                           softcap=cap)[:, -E:]] \
                if windowed else []
            # on the first rows, which attend few keys: on the last ones a
            # softmax over thousands of keys moves the output by less than
            # FLASH_TOL, with or without the cap
            nocap = [(attention_ref(q[:, :E], k[:, :E], v[:, :E],
                                    causal=True, window=window), head)] \
                if cap else []
            plain_note = (f"first and last {E} rows; plain_ms times the "
                          f"last {E} rows against the last {L} keys")
        tol = FLASH_TOL[dname]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
        check(all(torch.allclose(a.float(), b.float(), **tol)
                  for a, b in pairs),
              f"flash_attention_fwd {label}: kernel disagrees with "
              f"attention_ref (max abs err {err})")
        tiles_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in tile_pairs)
        check(all(torch.allclose(a.float(), b.float(), **tol)
                  for a, b in tile_pairs),
              f"flash_attention_fwd {label}: kernel disagrees with "
              f"attention_tiles_ref (max abs err {tiles_err})")
        want = pairs[-1][1].float()
        check(not torch.allclose(torch.zeros_like(want), want, **tol)
              and not torch.allclose(-want, want, **tol),
              f"flash_attention_fwd {label}: the tolerance cannot tell a "
              f"zero or a sign-flipped output from attention_ref")
        nowin_err = None
        if windowed:
            nw = nowin[0].float()
            nowin_err = float((nw - want).abs().max())
            check(not torch.allclose(nw, want, **tol),
                  f"flash_attention_fwd {label}: the tolerance cannot tell "
                  f"the output without the window from attention_ref")
        nocap_err = None
        if cap:
            nc, nc_want = (t.float() for t in nocap[0])
            nocap_err = float((nc - nc_want).abs().max())
            check(not torch.allclose(nc, nc_want, **tol),
                  f"flash_attention_fwd {label}: the tolerance cannot tell "
                  f"the output without the softcap from attention_ref")
        out_abs = float(want.abs().mean())
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * k.numel() * k.element_size()
        flops = 4 * B * Hq * hd * live_pairs(S, window)
        # past FLASH_PLAIN_MAX_S the yardsticks take tens of ms a call
        # (SDPA's masked call at (1, 32768): ~96 ms): 3 calls a run
        few = 3 if long else 20
        lib_err = lib_note = lib_compile_s = None
        if cap:
            lib_name = "torch.nn.attention.flex_attention (compiled)"
            lib, mask_s = flex_library(torch, q, k, v, window, cap)
        else:
            lib_name = "torch.nn.functional.scaled_dot_product_attention"
            lib = sdpa_library(torch, q, k, v, window, long)
        if lib is not None:
            t0 = time.perf_counter()
            try:
                lib_out = lib().transpose(1, 2)
                torch.cuda.synchronize()
            except Exception as exc:  # noqa: BLE001
                # the yardstick only: no SDPA backend of this PyTorch takes
                # the case (the math one would not fit), or flex_attention
                # does not compile it
                lib, lib_note = None, (f"{type(exc).__name__}: "
                                       f"{str(exc).splitlines()[0][:200]}")
            else:
                if cap:
                    lib_compile_s = time.perf_counter() - t0 + mask_s
                if long:
                    lib_out = lib_out[:, -FLASH_EDGE:]
                lib_err = float((lib_out.float() - want).abs().max())
                del lib_out
        # with a softcap, the kernel also with the cap off (the cost of
        # the tanh on every score), the two timed in turns
        times = time_interleaved(torch, {
            "ms": lambda: K.flash_attention_fwd(q, k, v, **kw),
            "ms_no_softcap": (lambda: K.flash_attention_fwd(
                q, k, v, causal=True, window=window)) if cap else None},
            launches=few, repeats=5)
        row = {"shape": label, "max_abs_err": err, "tol": tol,
               "tiles_max_abs_err": tiles_err, "tiles_block_k": block_k,
               "zero_err": float(want.abs().max()),
               "no_window_err": nowin_err, "no_softcap_err": nocap_err,
               "mean_abs_out": out_abs, **times,
               "plain_ms": time_ms(torch, plain, launches=1, repeats=3,
                                   warmup=1),
               "plain_checked": plain_note,
               "library_ms": None if lib is None else time_ms(
                   torch, lib, launches=few),
               "library": None if lib is None else lib_name,
               "library_compile_s": lib_compile_s,
               "library_max_abs_err": lib_err, "library_note": lib_note}
        row.update(bound_fields(torch, q.dtype, nbytes, flops, row["ms"]))
        wgmma = dname == "bf16"
        # the wgmma kernel has an instance with and one without the cap
        row["ptxas"] = ptxas_report(
            "flash_attention",
            f"flash_attention_fwd_wgmmaILi{hd}ELb{int(cap > 0)}EE" if wgmma
            else f"flash_attention_fwd_kernelILi{hd}EE")
        if wgmma:
            ptx = row["ptxas"]
            check(ptx["registers"] is not None and ptx["spill_stores"] == 0
                  and ptx["spill_loads"] == 0,
                  f"flash_attention_fwd {label}: the wgmma kernel at hd "
                  f"{hd} spills or has no ptxas report: {ptx}")
        rows.append(row)
        print(f"kernel flash_attention_fwd {label}: {json.dumps(row)}",
              flush=True)
        if hd == 256:
            ptx = row["ptxas"]
            print(f"flash hd256 {label}: {row['ms']:.4g} ms, bound "
                  f"{row['bound_ms']:.4g} ms ({100 * row['bound_share']:.1f}%"
                  f" of it), no softcap {row.get('ms_no_softcap')}, library "
                  f"{row['library_ms']}, {ptx['kernel']} {ptx['registers']} "
                  f"registers, spills {ptx['spill_stores']} / "
                  f"{ptx['spill_loads']} bytes", flush=True)
        del q, k, v, got, pairs, tile_pairs, nowin, nocap, want, lib
    torch.cuda.empty_cache()
    return rows


# The non-causal, cross-length branch of flash_attention_fwd (the encdec
# family's), held against attention_ref and attention_tiles_ref within
# FLASH_XTOL: (B, S, T, Hq, Hkv, hd, dtype, causal, softcap).  whisper's
# encoder, bidirectional 1500 x 1500 with 20/20 heads of 64 in bf16, at (y)'s
# prefill batch 8 and (x)'s cohort of 4 users; its decoder's cross-attention,
# (y)'s 448 tokens against 1500 frames, and (x)'s 128-token streams; f32
# non-causal and cross at T = 200, which no key tile divides; causal with
# T != S both ways (offset 0: query row i at position i), f32 and bf16; and
# the wgmma kernel's hd-128 and capped hd-256 instances, non-causal with T =
# 200.
FLASH_XCASES = (
    (8, 1500, 1500, 20, 20, 64, "bf16", False, 0.0),
    (4, 1500, 1500, 20, 20, 64, "bf16", False, 0.0),
    (8, 448, 1500, 20, 20, 64, "bf16", False, 0.0),
    (4, 128, 1500, 20, 20, 64, "bf16", False, 0.0),
    (2, 200, 200, 8, 8, 64, "f32", False, 0.0),
    (2, 96, 200, 8, 8, 64, "f32", False, 0.0),
    (2, 256, 200, 8, 8, 64, "bf16", True, 0.0),
    (2, 200, 256, 8, 8, 64, "bf16", True, 0.0),
    (2, 256, 200, 8, 8, 64, "f32", True, 0.0),
    (2, 200, 256, 8, 8, 64, "f32", True, 0.0),
    (1, 300, 200, 8, 4, 128, "bf16", False, 0.0),
    (1, 300, 200, 8, 4, 256, "bf16", False, 5.0),
)
# one bf16 step at outputs of order 1 (2^-6) in bf16; 2e-5 in f32, as
# FLASH_TOL
FLASH_XTOL = {"f32": dict(atol=2e-5, rtol=2e-5),
              "bf16": dict(atol=1.56e-2, rtol=1.56e-2)}


def flash_cross_inputs(torch, g, B, S, T, Hq, Hkv, hd, dtype):
    """q (B,S,Hq,hd) and k, v (B,T,Hkv,hd) on the card.  As flash_inputs,
    but the first head column of q is +c and of k -c, c = sqrt(2)·hd^(1/4),
    so that every score is centred at -2 (unit spread in bf16): a key that
    scores 0 outweighs a live one by e^1.5 on average, and the answer that
    gives the last key tile's rows past T (zeros) a score of 0 moves the
    output by ~10% at T = 1500 (36 such keys against 1500 live ones), twice
    FLASH_XTOL at outputs of order 1.  The shift leaves the reference's bf16
    rounding of q·k as it is at unit-normal inputs (|q·k| up to ~3 sigma)."""
    dev = "cuda"
    q_scale = 2.0 if dtype == torch.float32 else 1.0
    q = q_scale * torch.randn(B, S, Hq, hd, device=dev, generator=g)
    k = torch.randn(B, T, Hkv, hd, device=dev, generator=g)
    shift = (2.0 * hd ** 0.5) ** 0.5
    q[..., 0] = shift
    k[..., 0] = -shift
    pos = torch.arange(T, device=dev, dtype=torch.float32) / T
    v = torch.randn(B, T, Hkv, hd, device=dev, generator=g) \
        + pos[None, :, None, None]
    return q.to(dtype), k.to(dtype), v.to(dtype)


def cross_live_pairs(S, T, causal):
    """(query, key) pairs one head attends: S·T, or with the causal mask at
    offset 0 the sum over i of min(i + 1, T)."""
    if not causal:
        return S * T
    full = max(S - T, 0)
    first = min(S, T)
    return first * (first + 1) // 2 + full * T


def flash_cross_phase(torch):
    """flash_attention_fwd's non-causal, cross-length branch against
    attention_ref and attention_tiles_ref (at ``K.key_tile``'s tile) on the
    card at FLASH_XCASES within FLASH_XTOL.  Each case must also tell its
    answer from the other mask's (the causal one for a non-causal case,
    the non-causal one for a causal case) and, where the last key tile
    holds rows past T, from the answer that scores those rows (zeros) as
    0: the keys zero-padded to a tile multiple, unmasked.  The library
    time is one ``scaled_dot_product_attention`` call (a boolean mask for
    causal T != S, offset 0), or with a softcap one compiled
    ``flex_attention`` call (``flex_library``)."""
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                        attention_tiles_ref)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(4)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    rows = []
    for B, S, T, Hq, Hkv, hd, dname, causal, cap in FLASH_XCASES:
        label = (f"B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} hd={hd} {dname} "
                 + ("causal" if causal else "non-causal")
                 + (f" softcap={cap:g}" if cap else ""))
        q, k, v = flash_cross_inputs(torch, g, B, S, T, Hq, Hkv, hd,
                                     dtypes[dname])
        kw = dict(causal=causal, softcap=cap)
        got = K.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B, S, Hq, hd)
              and bool(torch.isfinite(got).all()),
              f"flash_attention_fwd {label}: output misshapen or not "
              f"finite")
        block_k = K.key_tile(q.dtype, hd)

        def plain():
            return attention_ref(q, k, v, **kw)
        want = plain().float()
        tiles = attention_tiles_ref(q, k, v, **kw, block_k=block_k).float()
        tol = FLASH_XTOL[dname]
        err = float((got.float() - want).abs().max())
        tiles_err = float((got.float() - tiles).abs().max())
        check(torch.allclose(got.float(), want, **tol),
              f"flash_attention_fwd {label}: kernel disagrees with "
              f"attention_ref (max abs err {err})")
        check(torch.allclose(got.float(), tiles, **tol),
              f"flash_attention_fwd {label}: kernel disagrees with "
              f"attention_tiles_ref (max abs err {tiles_err})")
        wrong = {"zero": torch.zeros_like(want), "sign": -want,
                 "other_mask": attention_ref(
                     q, k, v, causal=not causal, softcap=cap).float()}
        pad = -T % block_k
        if pad and (not causal or S > T):
            kz, vz = (torch.cat([t, t.new_zeros(B, pad, Hkv, hd)], dim=1)
                      for t in (k, v))
            wrong["unmasked_tail"] = attention_ref(q, kz, vz, **kw).float()
            del kz, vz
        wrong_err = {name: float((w - want).abs().max())
                     for name, w in wrong.items()}
        for name, w in wrong.items():
            check(not torch.allclose(w, want, **tol),
                  f"flash_attention_fwd {label}: the tolerance cannot tell "
                  f"the {name} answer from attention_ref")
        del wrong
        # the library call: SDPA with no mask, or offset-0 causal as a
        # boolean mask (its is_causal aligns non-square masks otherwise in
        # some backends); SDPA takes no softcap, so a capped case times a
        # compiled flex_attention call
        lib_err = lib_note = lib_compile_s = None
        if cap:
            lib_name = "torch.nn.attention.flex_attention (compiled)"
            lib, mask_s = flex_library(torch, q, k, v, 0, cap, causal)
        else:
            lib_name = "torch.nn.functional.scaled_dot_product_attention"
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            skw = dict(scale=hd ** -0.5, enable_gqa=Hq != Hkv)
            if causal:
                i = torch.arange(S, device="cuda")[:, None]
                j = torch.arange(T, device="cuda")[None, :]
                skw["attn_mask"] = j <= i

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt, **skw)
        t0 = time.perf_counter()
        try:
            lib_out = lib().transpose(1, 2).float()
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001
            lib, lib_note = None, (f"{type(exc).__name__}: "
                                   f"{str(exc).splitlines()[0][:200]}")
        else:
            if cap:
                lib_compile_s = time.perf_counter() - t0 + mask_s
            lib_err = float((lib_out - want).abs().max())
            del lib_out
        times = time_interleaved(torch, {
            "ms": lambda: K.flash_attention_fwd(q, k, v, **kw),
            "library_ms": lib}, launches=20, repeats=5)
        nbytes = 2 * q.numel() * q.element_size() \
            + 2 * k.numel() * k.element_size()
        flops = 4 * B * Hq * hd * cross_live_pairs(S, T, causal)
        row = {"shape": label, "max_abs_err": err, "tol": tol,
               "tiles_max_abs_err": tiles_err, "tiles_block_k": block_k,
               "wrong_answer_errs": wrong_err,
               "mean_abs_out": float(want.abs().mean()), **times,
               "plain_ms": time_ms(torch, plain, launches=1, repeats=3,
                                   warmup=1),
               "plain_checked": "whole case",
               "library": None if lib is None else lib_name,
               "library_compile_s": lib_compile_s,
               "library_max_abs_err": lib_err, "library_note": lib_note}
        row.update(bound_fields(torch, q.dtype, nbytes, flops, row["ms"]))
        wgmma = dname == "bf16"
        row["ptxas"] = ptxas_report(
            "flash_attention",
            f"flash_attention_fwd_wgmmaILi{hd}ELb{int(cap > 0)}EE" if wgmma
            else f"flash_attention_fwd_kernelILi{hd}EE")
        rows.append(row)
        print(f"kernel flash_attention_fwd {label}: {json.dumps(row)}",
              flush=True)
        del q, k, v, got, want, tiles, lib
    torch.cuda.empty_cache()
    return rows


def immediate_apply_ms(torch, params_cpu):
    """One immediate apply as the main path runs it: a host row of a
    materialized bank copied to the card, then one launch for the tree."""
    from repro_torch.core import apply_update, init_server_state
    from repro_torch.tree import tree_map
    state = init_server_state(params_cpu, device="cuda")
    row = tree_map(lambda x: 0.01 * x, params_cpu)
    return time_ms(torch, lambda: apply_update(state, row, 1.0, 3))


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def fig2_setup(torch):
    from repro_torch.configs.paper_models import MNIST_CNN
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import make_personalized_eval
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
    clients = make_federated_dataset("mnist", n_clients=30,
                                     classes_per_client=5, seed=0)
    params = init_cnn(MNIST_CNN, torch.Generator().manual_seed(0))
    loss = lambda p, b: cnn_loss(MNIST_CNN, p, b, train=False)  # noqa: E731
    acc = lambda p, b: cnn_accuracy(MNIST_CNN, p, b)  # noqa: E731
    ev = make_personalized_eval(loss, acc, clients, ft_steps=1, ft_lr=0.01)
    return clients, params, loss, ev


RUNS = {
    # name: (option, eta, schedule, rounds, eval_every)
    "a": ("C", 0.002, ("immediate",), 75, 15),
    "b": ("C", 0.002, ("buffered", 8), 80, 16),
    "c": ("B", 0.002, ("immediate",), 10, 5),
    "d": ("A", 0.01, ("sync_barrier", 10), 5, 1),
}


def fl_run(setup, strategy_spec, option, eta, sched, device, **kw):
    """An ``FLRun`` of the fig2 setup: ``strategy_spec`` is ``(name,
    kwargs)``, ``sched`` ``(schedule name, *args)``; ``kw`` goes to
    ``FLRun`` (the engine's ``cohort_impl``, ``mesh``, ...)."""
    from repro_torch.core import PersAFLConfig
    from repro_torch.fl import (DelayModel, FLRun, buffered, immediate,
                                strategy, sync_barrier)
    clients, params, loss, _ = setup
    schedule = {"immediate": immediate, "buffered": buffered,
                "sync_barrier": sync_barrier}[sched[0]](*sched[1:])
    return FLRun(clients=clients, loss_fn=loss, init_params=params,
                 pcfg=PersAFLConfig(option=option, eta=eta, **FIG2),
                 delays=DelayModel(len(clients), seed=0),
                 strategy=strategy(strategy_spec[0], **strategy_spec[1]),
                 schedule=schedule, batch_size=16, seed=0, device=device,
                 **kw)


def make_run(torch, setup, name, device):
    option, eta, sched, _, _ = RUNS[name]
    return fl_run(setup, ("persafl", {"option": option}), option, eta,
                  sched, device)


def finite(torch, params) -> bool:
    from repro_torch.tree import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))


@contextlib.contextmanager
def stacked_applies(K):
    """Counts the stacked applies ``FLRun`` makes (its calls of
    ``apply_buffered_rows``) while the block runs, and the ``apply_rows``
    launches planned for them (one per dtype pair and chunk of
    ``max_leaves()`` leaves of the params and the stack), into the dict it
    yields."""
    from repro_torch.fl import api
    from repro_torch.tree import tree_leaves
    real = api.apply_buffered_rows
    seen = {"applies": 0, "planned": 0}

    def counted(state, stack, *args, **kwargs):
        seen["applies"] += 1
        seen["planned"] += planned_launches(
            K, tree_leaves(state.params), tree_leaves(stack))
        return real(state, stack, *args, **kwargs)
    api.apply_buffered_rows = counted
    try:
        yield seen
    finally:
        api.apply_buffered_rows = real


@contextlib.contextmanager
def moe_drops():
    """Collects, into the list it yields, each MoE layer's count of the
    (token, slot) pairs capacity drops (``moe.dropped_pairs`` of the
    layer's input) while the block runs; for forwards outside ``vmap``."""
    from repro_torch.models import moe
    real = moe.moe_forward
    seen = []

    def counted(cfg, p, x):
        seen.append(int(moe.dropped_pairs(cfg, p, x)))
        return real(cfg, p, x)
    moe.moe_forward = counted
    try:
        yield seen
    finally:
        moe.moe_forward = real


def main_path(torch, setup):
    """Runs (a)-(d) on the card; returns their launch counts and
    histories."""
    from repro_torch.kernels.fused_update import kernel as K
    ev = setup[3]
    hists = {}
    K.reset_launches()
    with stacked_applies(K) as stacked:
        for name in RUNS:
            hists[name] = main_run(torch, setup, name, ev)
    launches = {k: K.LAUNCHES[k] for k in ("apply_scaled", "apply_rows")}
    print(f"main path launches: {json.dumps(launches)}, stacked applies "
          f"{json.dumps(stacked)}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    # one apply_scaled launch per immediate apply, one apply_rows launch per
    # stacked apply: the CNN's 8 leaves are one table
    applies = sum(RUNS[name][3] for name in RUNS
                  if RUNS[name][2] == ("immediate",))
    check(launches["apply_scaled"] == applies,
          f"apply_scaled launched {launches['apply_scaled']} times for "
          f"{applies} immediate applies")
    check(launches["apply_rows"] == stacked["planned"],
          f"apply_rows launched {launches['apply_rows']} times for "
          f"{stacked['applies']} stacked applies, {stacked['planned']} "
          f"planned")
    return launches, hists


def main_run(torch, setup, name, ev):
    """Runs ``name`` of RUNS on the card and checks it; returns its
    history."""
    run = make_run(torch, setup, name, "cuda")
    _, _, _, rounds, every = RUNS[name]
    t0 = time.perf_counter()
    hist = run.run(max_rounds=rounds, eval_every=every, eval_fn=ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(finite(torch, run.params), f"run ({name}): params not finite")
    check(hist.acc and all(0.0 <= a <= 1.0 for a in hist.acc),
          f"run ({name}): accuracy trajectory {hist.acc}")
    print(f"main path ({name}) {RUNS[name][:3]} rounds={rounds}: "
          f"wall {wall:.3f} s, acc {[round(a, 4) for a in hist.acc]}, "
          f"mean active ratio {float(sum(hist.active_ratio)) / max(len(hist.active_ratio), 1):.4f}, "
          f"max staleness {max(hist.staleness, default=0)}, "
          f"stats {json.dumps(run.stats)}", flush=True)
    return hist


def device_events(torch, prof):
    """(name, ms) of each device-side event of a finished ``torch.profiler``
    run, from its raw kineto events: building the profiler's function
    events instead costs ~60 µs of host time an event, tens of seconds for
    a serving flush's."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile_phase(torch, label: str, fn):
    """Device busy share of ``fn()`` under ``torch.profiler``: the CUDA
    kernels' summed time over the wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_events(torch, prof)
    busy_ms = sum(ms for _, ms in kernels)
    top = {}
    for name, ms in kernels:
        top[name] = top.get(name, 0.0) + ms
    top5 = sorted(top.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile {label}: wall {wall:.3f} s, device kernels "
          f"{len(kernels)}, device busy {busy_ms / 1e3:.3f} s "
          f"({100 * busy_ms / 1e3 / wall:.2f}% of wall), top "
          f"{json.dumps([(n[:60], round(t, 3)) for n, t in top5])} "
          f"(ms)", flush=True)


def profile_training(torch, setup, rounds: int = 10):
    """The first ``rounds`` rounds of (a)."""
    run = make_run(torch, setup, "a", "cuda")
    profile_phase(torch, f"(a) {rounds} rounds", lambda: run.run(
        max_rounds=rounds, eval_every=rounds, eval_fn=setup[3]))


def cpu_parity(torch, setup, main_hists):
    """The first 8 rounds of (a) and (b) on the card (twice) and on the
    CPU: identical timelines, also against the main path's own runs, and
    params within PARAM_ATOL."""
    from repro_torch.tree import tree_leaves
    for name in ("a", "b"):
        out = {}
        for device in ("cuda", "cuda", "cpu"):
            run = make_run(torch, setup, name, device)
            t0 = time.perf_counter()
            hist = run.run(max_rounds=8, eval_every=4, eval_fn=setup[3])
            out.setdefault(device, []).append(
                (hist, run, time.perf_counter() - t0))
        (hg, rg, tg), (_, rg2, _) = out["cuda"]
        (hc, rc, tc), = out["cpu"]
        spread = max(float((a - b).abs().max())
                     for a, b in zip(tree_leaves(rg.params),
                                     tree_leaves(rg2.params)))
        for field in ("times", "rounds", "staleness", "active_times",
                      "active_ratio", "end_time"):
            check(getattr(hg, field) == getattr(hc, field),
                  f"({name}) 8 rounds: {field} differs between card and CPU")
        # the 8-round timeline is a prefix of the main path's run (evals
        # aside, which follow eval_every)
        for field in ("staleness", "active_times", "active_ratio"):
            full = getattr(main_hists[name], field)
            check(full[:len(getattr(hc, field))] == getattr(hc, field),
                  f"({name}) 8 rounds: {field} is not a prefix of the "
                  f"main path's run")
        diff = max(float((a.cpu() - b).abs().max())
                   for a, b in zip(tree_leaves(rg.params),
                                   tree_leaves(rc.params)))
        acc_diff = max((abs(a - b) for a, b in zip(hg.acc, hc.acc)),
                       default=0.0)
        print(f"parity ({name}) 8 rounds: timeline identical "
              f"(staleness {hg.staleness}), max |param diff| {diff:.3e} "
              f"(tol {PARAM_ATOL}), card vs card {spread:.3e}, acc card {hg.acc} cpu {hc.acc}, "
              f"wall card {tg:.3f} s cpu {tc:.3f} s", flush=True)
        check(diff <= PARAM_ATOL, f"({name}) params differ by {diff}")
        check(acc_diff <= ACC_ATOL, f"({name}) accuracy differs by "
                                    f"{acc_diff}")


# ---------------------------------------------------------------------------
# phase (l): the paper's Figure 2 baselines FedProx and SCAFFOLD
# ---------------------------------------------------------------------------

# benchmarks/common.py:48-72's sync baselines on the fig2 setup: Option A's
# batch layout, η = 0.01, batch 16; name -> (strategy, kwargs, schedule,
# rounds, eval_every)
BASELINES = {
    "fedprox sync_barrier(10)": ("fedprox", {"mu": 0.1},
                                 ("sync_barrier", 10), 5, 1),
    "scaffold sync_barrier(10)": ("scaffold", {}, ("sync_barrier", 10), 5, 1),
    "scaffold buffered(8)": ("scaffold", {}, ("buffered", 8), 20, 4),
}


def baseline_run(setup, key, device):
    name, kw, sched, _, _ = BASELINES[key]
    return fl_run(setup, (name, kw), "A", 0.01, sched, device)


def baseline_main_run(torch, setup, key, rounds, every, ev):
    """Runs baseline ``key`` on the card for ``rounds`` rounds, checked."""
    run = baseline_run(setup, key, "cuda")
    t0 = time.perf_counter()
    hist = run.run(max_rounds=rounds, eval_every=every, eval_fn=ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(finite(torch, run.params), f"(l) {key}: params not finite")
    check(hist.acc and all(0.0 <= a <= 1.0 for a in hist.acc),
          f"(l) {key}: accuracy trajectory {hist.acc}")
    check(run.stats["host_materializations"] == 0,
          f"(l) {key}: {run.stats['host_materializations']} host "
          f"materializations")
    print(f"baselines (l) {key} rounds={rounds}: wall {wall:.3f} s, "
          f"acc {[round(a, 4) for a in hist.acc]}, "
          f"max staleness {max(hist.staleness, default=0)}, "
          f"stats {json.dumps(run.stats)}", flush=True)


def baselines_phase(torch, setup):
    """(l): FedProx and SCAFFOLD through ``FLRun`` on the card, counts
    zeroed just before and read just after; then 2 rounds of each sync run
    on the card and on the CPU."""
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.tree import tree_leaves
    ev = setup[3]
    K.reset_launches()
    with stacked_applies(K) as stacked:
        for key, (_, _, _, rounds, every) in BASELINES.items():
            baseline_main_run(torch, setup, key, rounds, every, ev)
    launches = {k: K.LAUNCHES[k] for k in ("apply_scaled", "apply_rows")}
    print(f"baselines (l) launches: {json.dumps(launches)}, stacked "
          f"applies {json.dumps(stacked)}", flush=True)
    # sync and buffered flushes fold the bank through apply_rows, one
    # launch per stacked apply
    check(launches["apply_rows"] == stacked["planned"] > 0,
          f"(l): apply_rows launched {launches['apply_rows']} times for "
          f"{stacked['applies']} stacked applies, {stacked['planned']} "
          f"planned")

    def max_diff(a, b):
        return max(float((x.cpu() - y.cpu()).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))
    for key in ("fedprox sync_barrier(10)", "scaffold sync_barrier(10)"):
        # the card twice, for its spread against itself
        runs = {run: baseline_run(setup, key, dev) for run, dev in (
            ("cuda", "cuda"), ("cuda again", "cuda"), ("cpu", "cpu"))}
        hists = {run: r.run(max_rounds=2, eval_every=1, eval_fn=ev)
                 for run, r in runs.items()}
        spread = max_diff(runs["cuda"].params, runs["cuda again"].params)
        for field in ("times", "rounds", "staleness", "active_times",
                      "active_ratio", "end_time"):
            check(getattr(hists["cuda"], field)
                  == getattr(hists["cpu"], field),
                  f"(l) {key} 2 rounds: {field} differs between card and "
                  f"CPU")
        diff = max_diff(runs["cuda"].params, runs["cpu"].params)
        cdiff = max_diff(runs["cuda"].strategy.c_global,
                         runs["cpu"].strategy.c_global) \
            if key.startswith("scaffold") else 0.0
        acc_diff = max(abs(a - b) for a, b in zip(hists["cuda"].acc,
                                                  hists["cpu"].acc))
        print(f"parity (l) {key} 2 rounds: timeline identical, max |param "
              f"diff| {diff:.3e}, max |c_global diff| {cdiff:.3e} (tol "
              f"{PARAM_ATOL}), card vs card {spread:.3e}, acc card "
              f"{hists['cuda'].acc} cpu {hists['cpu'].acc}", flush=True)
        check(diff <= PARAM_ATOL and cdiff <= PARAM_ATOL,
              f"(l) {key}: params differ by {diff}, c_global by {cdiff}")
        check(acc_diff <= ACC_ATOL, f"(l) {key}: accuracy differs by "
                                    f"{acc_diff}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the serving path
# ---------------------------------------------------------------------------

def serve_batches(clients, windows: int, seed: int = 0):
    """One request batch per user per window, drawn from the user's own
    training data by a seeded numpy generator."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(windows):
        row = []
        for c in clients:
            idx = rng.randint(0, c.n_train, SERVE_BATCH)
            row.append({"images": c.train_x[idx], "labels": c.train_y[idx]})
        out.append(row)
    return out


def drive_server(torch, srv, batches, windows: int, mode: str = "C",
                 stragglers: bool = True, after=None):
    """``windows`` aggregation windows: every user submits, the queue is
    flushed and every user's head gathered; at every third window a few
    users submit again after the flush and the window closes without
    flushing them, so the next window applies them with τ = 1.  Returns the
    number of contributing banks per window and the requests submitted."""
    uids = [f"user{u}" for u in range(len(batches[0]))]
    banks, submitted = [], 0
    for w in range(windows):
        for uid, b in zip(uids, batches[w]):
            srv.submit(uid, b, mode=mode)
        submitted += len(uids)
        srv.flush()
        srv.stacked_heads(uids)
        banks.append(len({id(b) for b, _, _ in srv.ring._pending}))
        if stragglers and w % 3 == 1:
            for uid, b in zip(uids[:SERVE_STRAGGLERS], batches[w]):
                srv.submit(uid, b, mode=mode)
            submitted += SERVE_STRAGGLERS
            srv.advance_window(flush=False)
        else:
            srv.advance_window()
        if after is not None:
            after(w, srv)
    torch.cuda.synchronize()
    return banks, submitted


def serving_phase(torch, setup):
    """(e): PersonalizationServer on the card, fp32 and int8 banking, 12
    windows each, then a head-only int8 server and a mode-B server for 4
    windows; counts zeroed just before and read just after.  Then the first
    3 int8 windows again on the CPU."""
    from repro_torch.core import PersAFLConfig
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.serving import PersonalizationServer
    from repro_torch.tree import tree_leaves
    clients, params, loss, ev = setup
    pcfg = PersAFLConfig(**SERVE)
    batches = serve_batches(clients, SERVE_WINDOWS)
    n_leaves = len(tree_leaves(params))
    runs = {
        # name: (server kwargs, windows, mode, stragglers)
        "fp32": (dict(delta_dtype="fp32", modes=("C",)), SERVE_WINDOWS,
                 "C", True),
        "int8": (dict(delta_dtype="int8", modes=("C",)), SERVE_WINDOWS,
                 "C", True),
        "int8 head-only": (dict(delta_dtype="int8", modes=("C",),
                                personal_subset="fc/#1"), 4, "C", False),
        "fp32 mode B": (dict(delta_dtype="fp32", modes=("B",)), 4, "B",
                        False),
    }
    out, expect = {}, {"apply_rows": 0, "apply_rows_q": 0}
    snap3 = {}

    def keep_third(w, srv):
        # the int8 server's params after its first 3 windows, and the
        # largest row scale its banks used, for the CPU comparison
        if w == 2:
            snap3["params"] = [x.detach().cpu() for x in
                               tree_leaves(srv.params)]
            snap3["max_scale"] = max(
                float(sc.max()) for bs in srv.ring._banks.values()
                for b in bs for sc in tree_leaves(b.stacked.scales))
            snap3["codes"] = [x.cpu() for x in tree_leaves(
                srv.ring._banks[0][0].stacked.q)]
    K.reset_launches()
    for name, (kw, windows, mode, strag) in runs.items():
        srv = PersonalizationServer(params, loss, pcfg, max_pending=64,
                                    device="cuda", **kw)
        leaves = len(tree_leaves(srv.personal_subset.extract(params))) \
            if srv.personal_subset is not None else n_leaves
        t0 = time.perf_counter()
        banks, submitted = drive_server(
            torch, srv, batches, windows, mode, strag,
            after=keep_third if name == "int8" else None)
        wall = time.perf_counter() - t0
        st = srv.stats
        # a bank's apply: apply_rows_q or apply_rows one launch per tree
        # (the CNN's leaves are one dtype combination and one table)
        kern = "apply_rows_q" if kw["delta_dtype"] == "int8" \
            else "apply_rows"
        expect[kern] += -(-leaves // K.max_leaves()) * sum(banks)
        acc = float(ev(srv.params)) if windows == SERVE_WINDOWS else None
        out[name] = dict(wall_per_window_s=wall / windows,
                         requests_per_s=submitted / wall,
                         requests=submitted, banks=banks, acc=acc,
                         stats={k: st[k] for k in (
                             "host_materializations", "ring_row_bytes",
                             "ring_bytes_per_user",
                             "ring_bytes_per_user_fp32", "ring_admitted",
                             "ring_stragglers", "ring_dropped",
                             "cohort_calls", "padding_waste")})
        check(finite(torch, srv.params), f"serving ({name}): params not "
                                         f"finite")
        check(st["host_materializations"] == 0,
              f"serving ({name}): {st['host_materializations']} host "
              f"materializations")
        print(f"serving ({name}) {windows} windows: wall per window "
              f"{wall / windows:.4f} s, {submitted / wall:.1f} requests/s, "
              f"banks per window {banks}, acc {acc}, "
              f"stats {json.dumps(out[name]['stats'])}", flush=True)
    launches = {k: K.LAUNCHES[k] for k in ("apply_rows", "apply_rows_q")}
    bpu = {k: out[k]["stats"]["ring_bytes_per_user"]
           for k in ("fp32", "int8")}
    ratio = bpu["fp32"] / bpu["int8"]
    gap = abs(out["fp32"]["acc"] - out["int8"]["acc"])
    print(f"serving ring_bytes_per_user fp32 {bpu['fp32']} int8 "
          f"{bpu['int8']} ratio {ratio:.4f}; personalized acc fp32 "
          f"{out['fp32']['acc']} int8 {out['int8']['acc']} gap {gap:.4f}; "
          f"launches {json.dumps(launches)} expected {json.dumps(expect)}",
          flush=True)
    check(ratio >= RING_RATIO, f"serving: ring ratio {ratio} < {RING_RATIO}")
    check(gap <= ACC_GAP, f"serving: accuracy gap {gap} > {ACC_GAP}")
    for k in launches:
        check(launches[k] == expect[k] > 0,
              f"serving: {k} launched {launches[k]} times, expected "
              f"{expect[k]} (apply_rows_q and apply_rows one per "
              f"tree, per contributing bank)")
    serving_cpu_parity(torch, setup, pcfg, batches, snap3)
    # where a window's time goes: 3 windows of a fresh int8 server
    srv = PersonalizationServer(params, loss, pcfg, max_pending=64,
                                device="cuda", delta_dtype="int8",
                                modes=("C",))
    profile_phase(torch, "(e) int8 3 windows", lambda: drive_server(
        torch, srv, batches, 3, stragglers=False))
    return launches, out


# CPU-vs-card agreement of the first 3 int8 windows.  The card's cuDNN and
# the CPU's oneDNN sum the f32 convolutions in other orders, so every delta
# differs in its last bits (PARAM_ATOL, as for training).  Quantization turns
# such a difference into a whole code where a delta element lies at a
# rounding boundary of x/scale: that element's update then differs by one
# code step, weight × scale ≤ β/M × the largest row scale (M = 30 admitted
# rows).  Error feedback carries the flipped code's error into the user's
# next delta, so a flip does not accumulate; the tolerance allows one step
# per window.
def serving_cpu_parity(torch, setup, pcfg, batches, snap3):
    from repro_torch.serving import PersonalizationServer
    from repro_torch.tree import tree_leaves
    clients, params, loss, _ = setup
    srv = PersonalizationServer(params, loss, pcfg, max_pending=64,
                                device="cpu", delta_dtype="int8",
                                modes=("C",))
    t0 = time.perf_counter()
    codes = {}

    def first_codes(w, s):
        if w == 0:
            codes["cpu"] = [x.clone() for x in tree_leaves(
                s.ring._banks[0][0].stacked.q)]
    drive_server(torch, srv, batches, 3, after=first_codes)
    wall = time.perf_counter() - t0
    step = pcfg.beta / len(clients) * snap3["max_scale"]
    tol = PARAM_ATOL + 3 * step
    diff = max(float((a - b).abs().max()) for a, b in
               zip(snap3["params"], tree_leaves(srv.params)))
    flipped = sum(int((a != b).sum()) for a, b in
                  zip(snap3["codes"], codes["cpu"]))
    total = sum(a.numel() for a in snap3["codes"])
    print(f"serving parity (int8) 3 windows card vs CPU: max |param diff| "
          f"{diff:.3e} (tol {tol:.3e} = {PARAM_ATOL} + 3 x code step "
          f"{step:.3e}); window 0 codes differing {flipped} of {total}; "
          f"CPU wall {wall:.3f} s", flush=True)
    check(diff <= tol, f"serving parity: params differ by {diff} > {tol}")


# ---------------------------------------------------------------------------
# phases (f)-(k): personalized LM serving, prefill, card vs CPU -- (f)-(h)
# mamba2-130m, (i)-(k) zamba2-1.2b
# ---------------------------------------------------------------------------

# the published widths: params and leaves of the reference's init
LM_PARAMS = {"mamba2-130m": (167_598_528, 12),
             "zamba2-1.2b": (1_183_058_816, 21),
             "gemma2-2b": (3_204_165_888, 14),
             "granite-moe-1b-a400m": (1_384_963_072, 13),
             "whisper-large-v3": (1_600_990_720, 25)}
# the serve driver's mode C: lambda 30, alpha 0.01, K 5, eta_in 0.01
LM_USERS, LM_TOKENS, LM_INNER_STEPS, LM_PROMPT = 4, 16, 5, 8
# zamba2's personal subset: the shared attention+MLP block and the
# unembedding (145,233,920 params a user); the full model's per-user copies
# would not fit 4 users in 80 GB
ZAMBA_SUBSET = "shared,embed/unembed"
# gemma2's personal subset: the unembedding (589,824,000 params a user,
# 2.36 GB in fp32); the whole model's per-user copies would not fit.  (r)
# serves GEMMA2_USERS users on personalization streams of GEMMA2_PLEN
# tokens (launch/serve.py's default, the 8-token prompt, is a toy length
# for a flush)
GEMMA2_SUBSET, GEMMA2_USERS, GEMMA2_PLEN = "embed/unembed", 4, 128
# allocator events kept while one call's peak device memory is split by
# the line that allocated each block
MEM_TRACE_ENTRIES = 2_000_000
# prefill shapes of phases (g), (j) and (s), (B, S): the kernel cases' long
# ones
PREFILL_SHAPES = ((8, 4096), (1, 32768))
# (t): gemma2 at 2 layers (0 local, 1 global) at a length past its window of
# 4096, so that the local layer's window binds; prefill only.  Its flush of
# 2 users was cut for the 1200 s budget: the CPU's prox steps on the
# 589,824,000-param unembedding took 49.6 s on 32-token streams and 49.1 s
# on 8-token ones, of a script at 1121 and 1149 s (NVIDIA H100 80GB HBM3 at
# 700 W); (w) and (k) hold the same subset flush card against CPU
GEMMA2_PARITY_SHAPE = (1, 4608)
# (u): granite's personal subset, the unembedding (50,334,720 params a
# user), 4 users on 128-token streams, as (r)
GRANITE_SUBSET, GRANITE_USERS, GRANITE_PLEN = "embed/unembed", 4, 128
# (w): granite at 2 layers at (2, 256), where capacity binds (C = 80 of a
# mean load of 64 per expert); deepseek-v3-671b cut to 1 dense-prefix layer
# and 1 MoE layer of 16 experts, with its shared expert and the MTP block,
# every width published (45 leaves, 3,706,691,584 params; the whole model's
# 671 B params need the multi-device paths), at (1, 128), and 8 decode steps
GRANITE_PARITY_SHAPE = (2, 256)
# (x): whisper's personal subset, the unembedding (66,388,480 params a
# user), 4 users on 128-token streams with the zero frames of its stubbed
# frontend, as (u); (y): its prefill at its published decoder context of
# 448 tokens, each row with its 1500 frames; (z): 2 encoder and 2 decoder
# layers at published widths and enc_len 1500, (2, 64), f32, card against
# CPU, and 8 decode steps against the card's teacher-forced logits
WHISPER_SUBSET, WHISPER_USERS, WHISPER_PLEN = "embed/unembed", 4, 128
WHISPER_PREFILL_SHAPES = ((8, 448), (32, 448))
WHISPER_CUT = dict(n_layers=2, enc_layers=2)
WHISPER_PARITY_SHAPE, WHISPER_DECODE = (2, 64), 8
DEEPSEEK_CUT = dict(n_layers=2, n_experts=16, first_k_dense=1)
DEEPSEEK_PARAMS = (3_706_691_584, 45)
DEEPSEEK_SHAPE, DEEPSEEK_DECODE = (1, 128), 8
# decode against prefill: the reference's own bound
# (tests/test_models_smoke.py:123)
DECODE_TOL = dict(atol=5e-4, rtol=5e-4)
# phases (h) and (k): card against CPU, f32, TF32 off.  The card runs the
# scan through ssd_fwd and the CPU through ssd_chunked (einsums), which sum
# the chunk products in other orders (ssd_fwd vs ssd_ref differ by up to
# 4.4e-4 at |y| ~ 25 in phase 2, 1.2e-5 relative); flash_attention_fwd and
# attention_ref sum q.k and p.v in other orders (2e-5 in f32); and cuBLAS
# and the CPU's GEMMs sum the projections and the unembedding differently:
# about 1e-5 relative on logits of order 1, hence 1e-4.  Heads are the
# global params minus 5 prox steps of eta_in = 0.01 on gradients that differ
# that little: 1e-5.
LM_PREFILL_TOL = dict(atol=1e-4, rtol=1e-4)
LM_HEAD_TOL = dict(atol=1e-5, rtol=0.0)


def lm_leaf_shapes(arch):
    """An LM's leaf shapes in tree order, from the config alone."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    if cfg.is_encdec:
        # models/encdec.py: dec_layers (cross, ln1, ln2, ln_x, mlp, self),
        # embed, enc_layers (attn, ln1, ln2, mlp), enc_norm, final_norm
        E, f = cfg.enc_layers, cfg.d_ff

        def att(n):
            return [(n, d, hkv), (n, hq, d), (n, d, hq), (n, d, hkv)]
        return (att(L) + [(L, d)] * 3 + [(L, d, f), (L, f, d)] + att(L)
                + [(V, d), (d, V)] + att(E) + [(E, d)] * 2
                + [(E, d, f), (E, f, d)] + [(d,), (d,)])
    if cfg.ssm is None:
        # models/lm.py: embed, final_norm, then the stacked layers' attn
        # (biases first), norms and MLP (or a MoE without shared experts:
        # router, then the stacked experts), then the visual projection
        shapes = [(V, d), (d, V), (d,)]
        if cfg.qkv_bias:
            shapes += [(L, hkv), (L, hq), (L, hkv)]
        shapes += [(L, d, hkv), (L, hq, d), (L, d, hq), (L, d, hkv)]
        shapes += [(L, d)] * (4 if cfg.post_block_norm else 2)
        if cfg.moe is not None:
            E, f = cfg.moe.n_experts, cfg.moe.expert_d_ff
            shapes += [(L, d, E), (L, E, f, d), (L, E, d, f), (L, E, d, f)]
        else:
            shapes += [(L, cfg.d_ff, d), (L, d, cfg.d_ff),
                       (L, d, cfg.d_ff)]
        return shapes + ([(d, d)] if cfg.n_visual_tokens else [])
    from repro_torch.models import mamba2 as m2
    s = cfg.ssm
    d_in, nh, conv = m2.dims(cfg)
    proj = 2 * d_in + 2 * s.n_groups * s.state_dim + nh
    shapes = [(V, d), (d, V), (d,), (L, d), (L, nh), (L, conv),
              (L, s.conv_width, conv), (L, nh), (L, nh), (L, d_in),
              (L, d, proj), (L, d_in, d)]
    if cfg.attn_every:
        shapes += [(2 * d, hkv), (hq, d), (2 * d, hq), (2 * d, hkv),
                   (2 * d,), (d,), (cfg.d_ff, d), (d, cfg.d_ff),
                   (d, cfg.d_ff)]
    return shapes


def lm_forward_launches(cfg):
    """(ssd_fwd, flash_attention_fwd) launches of one forward evaluation of
    an LM: one ssd_fwd per Mamba2 layer and one flash_attention_fwd per
    shared-block invocation (ssm_lm), one flash_attention_fwd per GQA
    layer (models/lm.py; MLA runs plain), or per encoder layer and two per
    decoder layer, self and cross (models/encdec.py)."""
    from repro_torch.models import ssm_lm
    if cfg.is_encdec:
        return 0, cfg.enc_layers + 2 * cfg.n_layers
    if cfg.ssm is None:
        return 0, 0 if cfg.mla is not None else cfg.n_layers
    return cfg.n_layers, ssm_lm.n_shared_slots(cfg)


def _stack_batches(torch, batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])).cuda()
            for k in batches[0]}


def _reset_lm_launches():
    from repro_torch.kernels.flash_attention import kernel as KF
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd import kernel as KS
    for mod in (K, KS, KF):
        mod.reset_launches()


def _lm_launches():
    from repro_torch.kernels.flash_attention import kernel as KF
    from repro_torch.kernels.ssd import kernel as KS
    return (KS.LAUNCHES["ssd_fwd"], KF.LAUNCHES["flash_attention_fwd"])


def lm_serving_phase(torch, arch, label, subset=None, users=LM_USERS,
                     plen=None, split_memory=False, ref_out=None):
    """(f) / (i) / (r): ``repro_torch.launch.serve.main`` on the card at
    full width, ``users`` users, mode C, fp32 and int8 banking, with
    ``subset`` as ``--personal-subset`` and ``plen`` as
    ``--personalize-len``; then one ``advance_window()`` per server.
    Counts and the peak of device memory are zeroed just before each run.
    With ``split_memory`` the int8 run is traced by the allocator from
    ``serve.main`` to a second flush, and the peaks of both split by
    allocating line (``memory_split``).  With ``ref_out`` (a dict) the
    fp32 run's heads and tokens are copied into it, on the host.  Returns
    per-codec numbers and the (int8 run's) config and params."""
    from torch.func import vmap

    from repro_torch.core.subset import merge_subset
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.launch import serve
    from repro_torch.models import api, lm
    from repro_torch.tree import tree_leaves, tree_map
    n_params_want, n_leaves_want = LM_PARAMS[arch]
    out, keep = {}, None
    for codec in ("fp32", "int8"):
        keep = None        # the last run's params leave the card first
        argv = ["--arch", arch, "--personalize", "--requests",
                str(users), "--tokens", str(LM_TOKENS), "--prompt-len",
                str(LM_PROMPT), "--inner-steps",
                str(LM_INNER_STEPS), "--device", "cuda",
                "--delta-dtype", codec, "--out",
                str(ROOT / "build" / "serve")]
        if subset:
            argv += ["--personal-subset", subset]
        if plen:
            argv += ["--personalize-len", str(plen)]
        split = split_memory and codec == "int8"
        if split:
            # the int8 run's device memory is split by allocating line: its
            # allocations are traced from here to its second flush
            mem_before = memory_record(torch)
        _reset_lm_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = serve.main(argv)
        main_wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if split:
            mark_main = len(memory_trace(torch))
        # read before the loss checks below, which launch the kernels too
        ssd_launches, flash_launches = _lm_launches()
        cfg, srv = run.cfg, run.server
        spec = srv.personal_subset
        leaves = tree_leaves(run.params)
        n_params = sum(x.numel() for x in leaves)
        check(n_params == n_params_want and len(leaves) == n_leaves_want,
              f"{label} {codec}: {n_params} params in {len(leaves)} leaves")
        check([tuple(x.shape) for x in leaves] == lm_leaf_shapes(arch),
              f"{label} {codec}: leaf shapes differ from the config's")
        check(all(bool(torch.isfinite(x).all())
                  for x in tree_leaves(run.heads)),
              f"{label} {codec}: personalized heads not finite")
        check(tuple(run.out_tokens.shape) == (users, LM_TOKENS),
              f"{label} {codec}: decoded {tuple(run.out_tokens.shape)}")
        if ref_out is not None and codec == "fp32":
            ref_out["heads"] = tree_map(lambda x: x.cpu(), run.heads)
            ref_out["tokens"] = run.out_tokens.cpu()
        # every user's head against the global params on their own stream,
        # one vmapped forward each; a subset head goes over the shared
        # backbone with in_dims None on the backbone's leaves
        batch = _stack_batches(torch, run.batches)
        loss = lambda p, b: api.loss_fn(cfg, p, b)  # noqa: E731
        if spec is not None:
            heads = merge_subset(run.params, run.heads)
            p_axes = tree_map(lambda m: 0 if m else None,
                              spec.mask(run.params))
        else:
            heads, p_axes = run.heads, 0
        with torch.no_grad():
            head_loss = vmap(loss, in_dims=(p_axes, 0))(heads, batch).cpu()
            glob_loss = vmap(loss, in_dims=(None, 0))(run.params,
                                                     batch).cpu()
            drops = None
            if cfg.moe is not None:
                # the (token, slot) pairs capacity drops in a forward of the
                # cohort's batch at the global params, one group a user, as
                # the vmapped cohort forward groups them
                with moe_drops() as drops:
                    lm.lm_hidden(cfg, run.params, batch["tokens"][:, 0])
        del heads
        st = srv.stats
        # K prox steps and nu's gradient per mode-C cohort call; an encdec
        # arch's decode also runs its encoder once, for the cross K/V of the
        # decode cache (under the users' vmap: one launch a layer)
        evals = (LM_INNER_STEPS + 1) * st["cohort_calls"]
        per = lm_forward_launches(cfg)
        decode_cache = cfg.enc_layers if cfg.is_encdec else 0
        expect = {"ssd_fwd": per[0] * evals,
                  "flash_attention_fwd": per[1] * evals + decode_cache}
        # the window apply of the one bank: apply_rows_q or apply_rows one
        # launch per tree of the personal leaves (one dtype combination)
        n_personal = len(tree_leaves(spec.extract(run.params))) \
            if spec is not None else len(leaves)
        kern = "apply_rows_q" if codec == "int8" else "apply_rows"
        want_launches = -(-n_personal // K.max_leaves())
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.advance_window()
        torch.cuda.synchronize()
        apply_wall = time.perf_counter() - t0
        apply_launches = K.LAUNCHES[kern]
        row = {
            "arch": arch, "personal_subset": subset,
            "params": n_params, "bytes_per_f32_copy": 4 * n_params,
            "personal_params": sum(x.numel() for x in tree_leaves(
                spec.extract(run.params))) if spec is not None else n_params,
            "main_wall_s": main_wall, "init_s": run.init_s,
            "peak_device_gb": peak_gb,
            "personalize_flush_s": run.personalize_s,
            "decode_s": run.decode_s,
            "decode_s_per_token": run.decode_s / LM_TOKENS,
            # the prompt's 7 warm-up steps and the 16 decode steps
            "decode_s_per_step": run.decode_s / (LM_PROMPT - 1 + LM_TOKENS),
            "tokens_per_s": run.record["tok_per_s"],
            "ring_bytes_per_user": st["ring_bytes_per_user"],
            "host_materializations": st["host_materializations"],
            "cohort_calls": st["cohort_calls"],
            "window_apply_s": apply_wall, "window_apply_kernel": kern,
            "window_apply_launches": apply_launches,
            "ssd_fwd_launches": ssd_launches,
            "flash_attention_fwd_launches": flash_launches,
            "flash_attention_fwd_launches_per_evaluation":
                (flash_launches - decode_cache) / evals,
            "flash_attention_fwd_launches_decode_cache": decode_cache,
            "expected_launches": expect, "loss_evaluations": evals,
            "head_loss": head_loss.tolist(),
            "global_loss": glob_loss.tolist()}
        if drops is not None:
            row["moe_dropped_pairs_per_forward"] = sum(drops)
            row["moe_dropped_pairs_by_layer"] = drops
            row["moe_pairs_per_forward"] = \
                users * batch["tokens"].shape[-1] * cfg.moe.top_k \
                * cfg.n_layers
        out[codec] = row
        print(f"{label} {arch} serving {codec}: {json.dumps(row)}",
              flush=True)
        check(st["host_materializations"] == 0,
              f"{label} {codec}: {st['host_materializations']} host "
              f"materializations")
        check(ssd_launches == expect["ssd_fwd"]
              and flash_launches == expect["flash_attention_fwd"],
              f"{label} {codec}: ssd_fwd launched {ssd_launches} and "
              f"flash_attention_fwd {flash_launches} times, expected "
              f"{expect} ({evals} forward evaluations)")
        check(bool((head_loss < glob_loss).all()),
              f"{label} {codec}: a personalized loss is not below the "
              f"global loss: {head_loss.tolist()} vs {glob_loss.tolist()}")
        check(apply_launches == want_launches,
              f"{label} {codec}: window apply launched {kern} "
              f"{apply_launches} times, expected {want_launches}")
        check(finite(torch, srv.params), f"{label} {codec}: params not "
                                         f"finite after the window apply")
        if codec == "int8":
            # where the serving path's time goes: a second cohort call of
            # the same users, and a short personalized decode
            def again():
                for user, b in zip(run.users, run.batches):
                    srv.submit(user, b)
                srv.flush()
            if split:
                # the second flush carries each user's banked residual,
                # the first does not
                mark, oom = len(memory_trace(torch)), None
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    again()
                except torch.OutOfMemoryError as exc:
                    oom = str(exc).splitlines()[0][:300]
                second_s = time.perf_counter() - t0
                second_peak = torch.cuda.max_memory_allocated() / 1e9
                trace = memory_trace(torch)
                memory_record(torch, on=False)
                row["memory"] = {
                    "serve_main": memory_split(trace, mem_before,
                                               stop=mark_main),
                    "second_flush": {
                        **memory_split(trace, mem_before, start=mark),
                        "wall_s": second_s,
                        "max_memory_allocated_gb": second_peak,
                        "oom": oom}}
                del trace
                for k, v in row["memory"].items():
                    print(f"{label} int8 run, device memory at the peak of "
                          f"{k} by allocating line: {json.dumps(v)}",
                          flush=True)
                check(oom is None, f"{label} int8: the second flush ran "
                                   f"out of device memory: {oom}")
            moe = cfg.moe is not None
            row["profile_flush"] = profile_shares(torch, again, moe=moe)
            row["profile_decode_4_tokens"] = profile_shares(
                torch, lambda: serve._decode_personalized(
                    cfg, run.heads, run.prompt, LM_PROMPT + 4, LM_PROMPT,
                    params=run.params, spec=spec), moe=moe)
            print(f"{label} profiles, int8 server: flush "
                  f"{json.dumps(row['profile_flush'])}; decode "
                  f"{json.dumps(row['profile_decode_4_tokens'])}",
                  flush=True)
        keep = (cfg, run.params)
        # leaves too: it would hold this run's params through the next
        # run's serve.main
        del run, srv, batch, leaves
        torch.cuda.empty_cache()
    bpu = {k: out[k]["ring_bytes_per_user"] for k in out}
    print(f"{label} {arch} ring_bytes_per_user fp32 {bpu['fp32']} int8 "
          f"{bpu['int8']} ratio {bpu['fp32'] / bpu['int8']:.4f}",
          flush=True)
    check(bpu["fp32"] >= RING_RATIO * bpu["int8"],
          f"{label}: int8 ring bytes per user not RING_RATIO below fp32")
    return out, keep


def _alloc_site(frames):
    """The innermost frame of this repo in an allocator trace's stack, as
    'path:line function'."""
    for f in frames:
        name = f["filename"]
        if "repro_torch" in name or name.endswith("chip_smoke.py"):
            short = name[name.rfind("repro_torch"):] \
                if "repro_torch" in name else "chip_smoke.py"
            return f"{short}:{f['line']} {f['name']}"
    return "(no frame of this repo)"


def memory_record(torch, on=True):
    """Start (``on``) or stop recording the caching allocator's trace with
    Python stacks; returns the bytes allocated now."""
    torch.cuda.synchronize()
    if on:
        torch.cuda.memory._record_memory_history(
            context="alloc", stacks="python", max_entries=MEM_TRACE_ENTRIES)
    else:
        torch.cuda.memory._record_memory_history(enabled=None)
    return torch.cuda.memory_allocated()


def memory_trace(torch):
    """The allocator's trace recorded so far on the current card."""
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    return snap["device_traces"][torch.cuda.current_device()]


def memory_split(trace, before, start=0, stop=None, top=14):
    """The peak of allocated device memory over ``trace[start:stop]``,
    split by the line that allocated each block live at the peak (blocks
    allocated since the trace began; the ``before`` bytes allocated when it
    began are one entry, less what of them was freed).  GB are 1e9 bytes
    of allocated blocks (the allocator's rounded sizes)."""
    stop = len(trace) if stop is None else stop

    def replay(end):
        # allocated bytes at the peak over [start, end), its index, and the
        # live blocks and the bytes from before the trace after event `end`
        live, cur, pre, peak, at = {}, 0, 0, -1, start
        for i, ev in enumerate(trace[:end]):
            act = ev["action"]
            if act == "alloc":
                live[ev["addr"]] = (ev["size"], ev.get("frames", ()))
                cur += ev["size"]
            elif act in ("free_requested", "free_completed"):
                if live.pop(ev["addr"], None) is not None:
                    cur -= ev["size"]
                elif act == "free_requested":
                    pre += ev["size"]     # a block from before the trace
            else:
                continue
            if i >= start and before - pre + cur > peak:
                peak, at = before - pre + cur, i
        return peak, at, live, before - pre
    peak, at, _, _ = replay(stop)
    _, _, live, kept = replay(at + 1)
    by_site = {}
    for size, frames in live.values():
        site = _alloc_site(frames)
        by_site[site] = by_site.get(site, 0) + size
    rows = sorted(by_site.items(), key=lambda kv: -kv[1])
    split = [("allocated before the trace, still live", kept)] + rows[:top]
    if rows[top:]:
        split.append((f"{len(rows) - top} other lines",
                      sum(b for _, b in rows[top:])))
    return {"peak_gb": peak / 1e9, "events": stop - start,
            "trace_full": len(trace) >= MEM_TRACE_ENTRIES,
            "split_gb": [(k, round(b / 1e9, 4)) for k, b in split]}


# the MoE layer's routing and dispatch kernels (models/moe.py), by name: the
# router's top-k sort and the pairs' sort by expert, the run starts' scan,
# the scatters of the counts, ranks and slot map, the index_selects (a
# gather kernel) of dispatch and combine (the embedding's row gather falls
# here too)
MOE_DISPATCH_NAMES = ("sort", "scan", "scatter", "gather", "indexselect",
                      "index_select")


def profile_shares(torch, fn, compare_readers=False, moe=False):
    """Wall, device busy time, and device time in ssd_fwd, in
    flash_attention_fwd, in GEMMs and in everything else, of one ``fn()``
    under ``torch.profiler``; with ``moe``, the MoE's routing and dispatch
    kernels (MOE_DISPATCH_NAMES) are a class of their own, each listed by
    name.  With ``compare_readers`` the same profile is
    also read through the profiler's function events (``prof.events()``,
    the slow reader ``device_events`` replaced), whose device-event count
    and busy time must agree with the raw events'."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sums = {"ssd_fwd": 0.0, "flash_attention_fwd": 0.0, "gemm": 0.0,
            "other": 0.0}
    if moe:
        sums["moe_dispatch"] = 0.0
    by_name, dispatch = {}, {}
    kernels = device_events(torch, prof)
    n = len(kernels)
    for full, ms in kernels:
        name = full.lower()
        # cuBLAS names its Hopper GEMMs nvjet_*, its older ones *gemm*/xmma
        key = "ssd_fwd" if "ssd_fwd" in name else \
            "flash_attention_fwd" if "flash_attention_fwd" in name else \
            "gemm" if any(w in name for w in ("gemm", "xmma", "cutlass",
                                              "nvjet")) else "other"
        if moe and key == "other" and any(w in name
                                          for w in MOE_DISPATCH_NAMES):
            key = "moe_dispatch"
            dispatch[full[:80]] = dispatch.get(full[:80], 0.0) + ms
        sums[key] += ms
        by_name[full[:60]] = by_name.get(full[:60], 0.0) + ms
    busy = sum(sums.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    readers = None
    if compare_readers:
        t0 = time.perf_counter()
        fev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        fbusy = sum(e.time_range.elapsed_us() for e in fev) / 1e3
        readers = {"raw": {"device_kernels": n, "busy_ms": busy},
                   "function_events": {
                       "device_kernels": len(fev), "busy_ms": fbusy,
                       "read_s": time.perf_counter() - t0}}
        print(f"profile readers on one profile: {json.dumps(readers)}",
              flush=True)
        check(len(fev) == n and abs(fbusy - busy) <= 1e-3 * busy + 1e-3,
              f"the raw-event and function-event readers disagree: "
              f"{readers}")
    return {"wall_ms": wall * 1e3, "device_kernels": n, "busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            **{f"{k}_ms": v for k, v in sums.items()},
            **{f"{k}_share": v / busy if busy else 0.0
               for k, v in sums.items()},
            "top_ms": [(k, round(v, 3)) for k, v in top],
            **({"moe_dispatch_by_name_ms": sorted(
                ((k, round(v, 3)) for k, v in dispatch.items()),
                key=lambda kv: -kv[1])} if moe else {}),
            **({"readers": readers} if readers else {})}


def prefill_phase(torch, cfg, params, label, calls=3,
                  compare_readers=False, shapes=PREFILL_SHAPES):
    """(g) / (j) / (s) / (v) / (y): ``make_prefill_step`` at full width,
    bf16 activations, at ``shapes`` (B, S): wall per call (``calls`` calls
    after a warm-up), ssd_fwd and flash_attention_fwd launches (per
    ``lm_forward_launches``, each call), the kernels the ssd_fwd calls
    launched, the peak of device memory, and one call under the
    profiler (the first shape's read by both readers with
    ``compare_readers``).  An encdec arch's batch carries the zero frames
    of its stubbed frontend, (B, enc_len, d_model), and its rows the
    encoder frames per second beside the decoder tokens."""
    from repro_torch.kernels.ssd import kernel as KS
    from repro_torch.launch import steps
    step = steps.make_prefill_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(2)
    per_call = lm_forward_launches(cfg)
    out = {}
    for B, S in shapes:
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                         device="cuda", dtype=torch.int32)}
        if cfg.is_encdec:
            batch["frames"] = torch.zeros((B, cfg.enc_len, cfg.d_model),
                                          dtype=cfg.activation_dtype,
                                          device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            logits = step(params, batch)
            torch.cuda.synchronize()
            check(tuple(logits.shape) == (B, cfg.vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"{label} prefill ({B}, {S}): logits "
                  f"{tuple(logits.shape)} not finite or misshapen")
            _reset_lm_launches()
            walls = []
            for _ in range(calls):
                t0 = time.perf_counter()
                step(params, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = _lm_launches()
            ssd_kernels = KS.LAUNCHES["ssd_fwd_kernels"]
            check(launches == (calls * per_call[0], calls * per_call[1]),
                  f"{label} prefill ({B}, {S}): ssd_fwd and "
                  f"flash_attention_fwd launched {launches} times in "
                  f"{calls} calls, expected {calls} x {per_call}")
            prof = profile_shares(
                torch, lambda: step(params, batch),
                compare_readers=compare_readers and not out,
                moe=cfg.moe is not None)
        row = {"wall_ms": [w * 1e3 for w in walls],
               "wall_ms_median": statistics.median(walls) * 1e3,
               "tokens_per_s": B * S / statistics.median(walls),
               "encoder_frames_per_s": B * cfg.enc_len
               / statistics.median(walls) if cfg.is_encdec else None,
               "ssd_fwd_launches_per_call": launches[0] // calls,
               "ssd_fwd_kernels_per_call": ssd_kernels / calls,
               "flash_attention_fwd_launches_per_call": launches[1] // calls,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "profile": prof}
        out[f"{B}x{S}"] = row
        print(f"{label} {cfg.arch_id} prefill (B, S) = ({B}, {S}) bf16: "
              f"{json.dumps(row)}", flush=True)
        del batch, logits
        torch.cuda.empty_cache()
    return out


def _close(torch, got, want, tol):
    """Within ``tol``, and a zero and a sign-flipped ``want`` are not."""
    return (torch.allclose(got, want, **tol)
            and not torch.allclose(torch.zeros_like(want), want, **tol)
            and not torch.allclose(-want, want, **tol))


def lm_cpu_parity(torch, arch, n_layers, label, subset=None, shape=(2, 256),
                  plen=128, flush=True, card_init=False):
    """(h) / (k) / (t) / (w): ``arch`` at full width but ``n_layers``
    layers, f32, on the card and on the CPU: prefill_logits at ``shape``
    (B, S), and with ``flush`` the heads of one mode-C flush of 2 users on
    streams of ``plen`` tokens (``subset`` personalized, else the whole
    model).  QKV biases, zero at init, are drawn non-zero; with local/global
    alternation, an all-global copy of the config must give other logits.
    With ``card_init`` the params are drawn on the card by the init's own
    laws from a CUDA generator and copied to the host, as (w)'s deepseek
    cut is: the host's one-threaded generator took 12.58 and 11.45 s for
    (t)'s two cuts, whose 256,000- and 92,416-row embeddings hold most of
    their params (beside an NVIDIA H100 80GB HBM3 at 700 W)."""
    from repro_torch.configs import get_config
    from repro_torch.core import PersAFLConfig
    from repro_torch.data import synthetic_token_batch
    from repro_torch.launch import serve
    from repro_torch.models import api, lm
    from repro_torch.serving import PersonalizationServer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    dev = "cuda" if card_init else "cpu"
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.device(dev):
        params = api.init_params(cfg, gen, dev)
        if cfg.qkv_bias:
            attn = params["layers"]["attn"]
            for k in ("bq", "bk", "bv"):
                attn[k] = 0.5 * torch.randn(attn[k].shape, generator=gen)
    if card_init:
        p_gpu, p_cpu = params, tree_map(lambda x: x.cpu(), params)
    else:
        p_cpu, p_gpu = params, tree_map(lambda x: x.cuda(), params)
    del params
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(synthetic_token_batch(5, *shape,
                                                    cfg.vocab)["tokens"])
    _reset_lm_launches()
    with torch.no_grad():
        lg = api.prefill_logits(cfg, p_gpu, {"tokens": tokens.cuda()}).cpu()
        launches = _lm_launches()
        drops = None
        if cfg.moe is not None:
            # capacity binds at this shape: both sides drop the same pairs
            drops = {}
            with moe_drops() as drops["cuda"]:
                lm.lm_hidden(cfg, p_gpu, tokens.cuda())
            with moe_drops() as drops["cpu"]:
                lm.lm_hidden(cfg, p_cpu, tokens)
        t0 = time.perf_counter()
        lc = api.prefill_logits(cfg, p_cpu, {"tokens": tokens})
        cpu_prefill_s = time.perf_counter() - t0
        glob_diff = None
        if cfg.local_global_period:
            glob = dataclasses.replace(cfg, local_global_period=0,
                                       sliding_window=0)
            lglob = api.prefill_logits(glob, p_gpu,
                                       {"tokens": tokens.cuda()}).cpu()
            glob_diff = float((lglob - lc).abs().max())
    diff = float((lg - lc).abs().max())
    check(_close(torch, lg, lc, LM_PREFILL_TOL),
          f"{label} prefill logits card vs CPU differ by {diff} (tol "
          f"{LM_PREFILL_TOL})")
    print(f"{label} card vs CPU, {arch} at {n_layers} layers f32, prefill "
          f"{tuple(shape)}: logits max |diff| {diff:.3e} (tol "
          f"{LM_PREFILL_TOL}; card launches ssd_fwd/flash_attention_fwd "
          f"{launches}); all-global copy max |diff| {glob_diff}; "
          f"{'card init and copy to the host' if card_init else 'host init'}"
          f" {init_s:.2f} s, CPU prefill {cpu_prefill_s:.2f} s"
          + (f"; (token, slot) pairs dropped by layer, card {drops['cuda']} "
             f"CPU {drops['cpu']}" if drops else ""), flush=True)
    if drops is not None:
        check(drops["cuda"] == drops["cpu"] and sum(drops["cpu"]) > 0,
              f"{label}: dropped pairs card {drops['cuda']} CPU "
              f"{drops['cpu']}: capacity must bind, the same on both sides")
    check(launches == lm_forward_launches(cfg),
          f"{label}: the card's prefill launched ssd_fwd and "
          f"flash_attention_fwd {launches} times")
    if glob_diff is not None:
        check(not torch.allclose(lglob, lc, **LM_PREFILL_TOL),
              f"{label}: the all-global copy's logits are within the "
              f"tolerance of the windowed ones: the check cannot see the "
              f"window")
    out = {"prefill_diff": diff, "launches": launches,
           "all_global_diff": glob_diff, "dropped_pairs": drops}
    if not flush:
        return out
    pcfg = PersAFLConfig(option="C", lam=30.0, alpha=0.01, inner_steps=5,
                         inner_eta=0.01)
    batches = [serve._user_batch(cfg, u, plen) for u in range(2)]
    heads, walls = {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        srv = PersonalizationServer(
            params, lambda p, b: api.loss_fn(cfg, p, b), pcfg, modes=("C",),
            max_pending=2, device=dev, personal_subset=subset)
        t0 = time.perf_counter()
        for u, b in enumerate(batches):
            srv.submit(f"user{u}", b)
        srv.flush()
        heads[dev] = [x.cpu() for x in tree_leaves(
            srv.stacked_heads(["user0", "user1"]))]
        walls[dev] = time.perf_counter() - t0
        base = srv.personal_subset.extract(p_cpu) \
            if srv.personal_subset is not None else p_cpu
        del srv
    hdiff = max(float((a - b).abs().max())
                for a, b in zip(heads["cuda"], heads["cpu"]))
    moved = max(float((h - p[None]).abs().max())
                for h, p in zip(heads["cpu"], tree_leaves(base)))
    print(f"{label} card vs CPU, {arch} at {n_layers} layers f32"
          f"{' subset ' + subset if subset else ''}: heads of a mode-C "
          f"flush of 2 users on {plen} tokens max |diff| {hdiff:.3e} (tol "
          f"{LM_HEAD_TOL}), heads moved {moved:.3e}; flush wall card "
          f"{walls['cuda']:.3f} s cpu {walls['cpu']:.3f} s", flush=True)
    check(all(torch.allclose(a, b, **LM_HEAD_TOL)
              for a, b in zip(heads["cuda"], heads["cpu"])),
          f"{label} heads card vs CPU differ by {hdiff}")
    check(moved > 10 * LM_HEAD_TOL["atol"],
          f"{label} heads moved only {moved}: the check cannot see a no-op")
    out.update(head_diff=hdiff, moved=moved)
    return out


def gemma2_phases(torch):
    """(r) gemma2-2b served at full width through ``launch.serve.main``
    (GEMMA2_USERS users on streams of GEMMA2_PLEN tokens,
    ``--personal-subset embed/unembed``, fp32 then int8, one window apply
    each, the int8 server's second flush split by allocating line), (s) its prefill at PREFILL_SHAPES, 2 timed calls
    each, (t) card against CPU: gemma2 at 2 layers (the window binds at
    GEMMA2_PARITY_SHAPE) and codeqwen1.5-7b at 2 layers (QKV biases, MHA
    32/32 of 128, rope theta 1e6), prefill only.  Returns (r)'s and (s)'s
    rows."""
    gl, (g_cfg, g_params) = lm_serving_phase(
        torch, "gemma2-2b", "(r)", subset=GEMMA2_SUBSET, users=GEMMA2_USERS,
        plen=GEMMA2_PLEN, split_memory=True)
    gprefill = prefill_phase(torch, g_cfg, g_params, "(s)", calls=2,
                             compare_readers=True)
    del g_params
    torch.cuda.empty_cache()
    lm_cpu_parity(torch, "gemma2-2b", 2, "(t)", subset=GEMMA2_SUBSET,
                  shape=GEMMA2_PARITY_SHAPE, flush=False, card_init=True)
    torch.cuda.empty_cache()
    lm_cpu_parity(torch, "codeqwen1.5-7b", 2, "(t)", flush=False,
                  card_init=True)
    torch.cuda.empty_cache()
    return gl, gprefill


def deepseek_cpu_parity(torch, label):
    """(w): deepseek-v3-671b cut to DEEPSEEK_CUT, every width published,
    f32, on the card and on the CPU at DEEPSEEK_SHAPE: the loss (its aux
    and 0.1 x MTP terms included; the MTP term must move it past the
    tolerance), ``prefill_logits`` and the dropped pairs; then
    DEEPSEEK_DECODE absorbed-MLA decode steps on the card against the
    card's prefill logits of those tokens.  MLA and the MoE run plain: no
    kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batch
    from repro_torch.models import api, lm
    from repro_torch.tree import tree_leaves, tree_map
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(
        full, n_layers=DEEPSEEK_CUT["n_layers"], dtype="float32",
        moe=dataclasses.replace(full.moe,
                                n_experts=DEEPSEEK_CUT["n_experts"],
                                first_k_dense=DEEPSEEK_CUT["first_k_dense"]))
    t0 = time.perf_counter()
    # the init's own laws, each tensor made on the card (the default device
    # inside the block) from a CUDA generator: the host's one-threaded
    # generator takes tens of seconds for 3.7e9 params
    with torch.device("cuda"):
        p_gpu = api.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(p_cpu)
    got = (sum(x.numel() for x in leaves), len(leaves))
    check(got == DEEPSEEK_PARAMS, f"{label} deepseek cut: {got[0]} params "
                                  f"in {got[1]} leaves")
    check(all(x.is_cuda for x in tree_leaves(p_gpu)),
          f"{label} deepseek cut: a leaf was made off the card")
    B, S = DEEPSEEK_SHAPE
    cpu = {k: torch.from_numpy(v) for k, v in synthetic_token_batch(
        5, B, S, cfg.vocab).items()}
    gpu = {k: v.cuda() for k, v in cpu.items()}
    no_mtp = dataclasses.replace(cfg, use_mtp=False)
    res = {}
    _reset_lm_launches()
    with torch.no_grad():
        for dev, params, batch in (("cuda", p_gpu, gpu), ("cpu", p_cpu, cpu)):
            t0 = time.perf_counter()
            with moe_drops() as drops:
                _, aux = lm.lm_hidden(cfg, params, batch["tokens"])
            res[dev] = {"loss": api.loss_fn(cfg, params, batch).cpu(),
                        "loss_no_mtp": api.loss_fn(no_mtp, params,
                                                   batch).cpu(),
                        "prefill": api.prefill_logits(cfg, params,
                                                      batch).cpu(),
                        "aux": aux.cpu(), "drops": drops,
                        "s": time.perf_counter() - t0}
            if dev == "cuda":
                # absorbed-MLA decode against the card's prefill, at
                # capacity_factor 8.0 so that nothing drops, as the
                # reference's own check sets it
                wide = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=8.0))
                toks = batch["tokens"][:, :DEEPSEEK_DECODE]
                want = lm.lm_logits(wide, params, toks)[0]
                cache = api.init_cache(wide, params, {"tokens": toks[:, :1]},
                                       DEEPSEEK_DECODE, torch.float32)
                steps = []
                for pos in range(DEEPSEEK_DECODE):
                    logits, cache = api.decode_step(
                        wide, params, cache, toks[:, pos:pos + 1], pos)
                    steps.append(logits[:, 0])
                dec = torch.stack(steps, dim=1)
                dec_diff = float((dec - want).abs().max())
                dec_ok = _close(torch, dec, want, DECODE_TOL)
                launches = _lm_launches()
    g, c = res["cuda"], res["cpu"]
    diffs = {k: float((g[k] - c[k]).abs().max())
             for k in ("loss", "prefill", "aux")}
    mtp_move = float((c["loss"] - c["loss_no_mtp"]).abs())
    print(f"{label} card vs CPU, deepseek-v3-671b cut to "
          f"{json.dumps(DEEPSEEK_CUT)} ({got[0]} params in {got[1]} "
          f"leaves, init on the card and copy to the host {init_s:.2f} s), f32, {DEEPSEEK_SHAPE}: loss "
          f"card {float(g['loss']):.6f} CPU {float(c['loss']):.6f} (aux "
          f"{float(c['aux']):.6e}, the MTP term moves it by {mtp_move:.4e}), "
          f"max |diff| {json.dumps(diffs)} (tol {LM_PREFILL_TOL}); dropped "
          f"pairs card {g['drops']} CPU {c['drops']}; {DEEPSEEK_DECODE} "
          f"absorbed-MLA decode steps vs the card's prefill max |diff| "
          f"{dec_diff:.3e} (tol {DECODE_TOL}); launches ssd_fwd/"
          f"flash_attention_fwd {launches}; walls card {g['s']:.2f} s CPU "
          f"{c['s']:.2f} s", flush=True)
    for k in ("loss", "prefill", "aux"):
        check(_close(torch, g[k], c[k], LM_PREFILL_TOL),
              f"{label} deepseek {k} card vs CPU differs by {diffs[k]}")
    check(not torch.allclose(c["loss_no_mtp"], c["loss"], **LM_PREFILL_TOL),
          f"{label} deepseek: the loss without its MTP term is within the "
          f"tolerance of the loss")
    check(g["drops"] == c["drops"], f"{label} deepseek: dropped pairs card "
                                    f"{g['drops']} CPU {c['drops']}")
    check(dec_ok, f"{label} deepseek: decode differs from prefill by "
                  f"{dec_diff}")
    check(launches == (0, 0), f"{label} deepseek: kernels launched "
                              f"{launches}; MLA and the MoE run plain")
    return {"diffs": diffs, "decode_diff": dec_diff, "init_s": init_s}


def moe_phases(torch):
    """(u) granite-moe-1b-a400m served at full width through
    ``launch.serve.main`` (GRANITE_USERS users on GRANITE_PLEN-token
    streams, ``--personal-subset embed/unembed``, fp32 then int8, one
    window apply each), (v) its prefill at PREFILL_SHAPES, 2 timed calls
    each, (w) card against CPU: granite at 2 layers at
    GRANITE_PARITY_SHAPE with one flush, and deepseek-v3-671b cut to
    DEEPSEEK_CUT.  Returns (u)'s and (v)'s rows."""
    ul, (u_cfg, u_params) = lm_serving_phase(
        torch, "granite-moe-1b-a400m", "(u)", subset=GRANITE_SUBSET,
        users=GRANITE_USERS, plen=GRANITE_PLEN)
    uprefill = prefill_phase(torch, u_cfg, u_params, "(v)", calls=2)
    del u_params
    torch.cuda.empty_cache()
    lm_cpu_parity(torch, "granite-moe-1b-a400m", 2, "(w)",
                  subset=GRANITE_SUBSET, shape=GRANITE_PARITY_SHAPE)
    torch.cuda.empty_cache()
    deepseek_cpu_parity(torch, "(w)")
    torch.cuda.empty_cache()
    return ul, uprefill


def encdec_cpu_parity(torch, label):
    """(z): whisper-large-v3 cut to WHISPER_CUT (2 encoder and 2 decoder
    layers, every width published, enc_len 1500), f32, on the card and on
    the CPU at WHISPER_PARITY_SHAPE with unit-normal frames: the loss and
    ``prefill_logits`` within LM_PREFILL_TOL, the card's kernel launches
    (6 a forward evaluation: 2 non-causal, 2 causal, 2 cross); then
    WHISPER_DECODE decode steps on the card (the cross K/V of
    ``init_cache``, plain ``sdpa``) against the card's teacher-forced
    logits of those tokens within DECODE_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_token_batch
    from repro_torch.models import api
    from repro_torch.models import encdec as ed
    from repro_torch.models.layers import unembed
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              dtype="float32", **WHISPER_CUT)
    t0 = time.perf_counter()
    p_cpu = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_s = time.perf_counter() - t0
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    n_params = sum(x.numel() for x in tree_leaves(p_cpu))
    B, S = WHISPER_PARITY_SHAPE
    data = synthetic_token_batch(5, B, S, cfg.vocab)
    data["frames"] = np.random.RandomState(6).randn(
        B, cfg.enc_len, cfg.d_model).astype(np.float32)
    cpu = {k: torch.from_numpy(v) for k, v in data.items()}
    gpu = {k: v.cuda() for k, v in cpu.items()}
    res = {}
    _reset_lm_launches()
    with torch.no_grad():
        for dev, params, batch in (("cuda", p_gpu, gpu), ("cpu", p_cpu, cpu)):
            t0 = time.perf_counter()
            res[dev] = {"loss": api.loss_fn(cfg, params, batch).cpu(),
                        "prefill": api.prefill_logits(cfg, params,
                                                      batch).cpu(),
                        "s": time.perf_counter() - t0}
            if dev == "cuda":
                launches = _lm_launches()
                toks = batch["tokens"][:, :WHISPER_DECODE]
                enc_h = ed.encode(cfg, params, batch["frames"])
                want = unembed(params["embed"], ed.decode_full(
                    cfg, params, toks, enc_h), cfg.final_softcap)
                cache = api.init_cache(cfg, params, {
                    "tokens": toks[:, :1], "frames": batch["frames"]},
                    WHISPER_DECODE, torch.float32)
                steps = []
                for pos in range(WHISPER_DECODE):
                    logits, cache = api.decode_step(
                        cfg, params, cache, toks[:, pos:pos + 1], pos)
                    steps.append(logits[:, 0])
                dec = torch.stack(steps, dim=1)
                dec_diff = float((dec - want).abs().max())
                dec_ok = _close(torch, dec, want, DECODE_TOL)
    g, c = res["cuda"], res["cpu"]
    diffs = {k: float((g[k] - c[k]).abs().max()) for k in ("loss",
                                                            "prefill")}
    want_launches = tuple(2 * n for n in lm_forward_launches(cfg))
    print(f"{label} card vs CPU, whisper-large-v3 cut to "
          f"{json.dumps(WHISPER_CUT)} ({n_params} params, host init "
          f"{init_s:.2f} s), f32, {WHISPER_PARITY_SHAPE} against "
          f"{cfg.enc_len} frames: loss card {float(g['loss']):.6f} CPU "
          f"{float(c['loss']):.6f}, max |diff| {json.dumps(diffs)} (tol "
          f"{LM_PREFILL_TOL}); {WHISPER_DECODE} decode steps vs the card's "
          f"teacher-forced logits max |diff| {dec_diff:.3e} (tol "
          f"{DECODE_TOL}); launches ssd_fwd/flash_attention_fwd of the "
          f"card's loss and prefill {launches} (expected {want_launches}); "
          f"walls card {g['s']:.2f} s CPU {c['s']:.2f} s", flush=True)
    for k in ("loss", "prefill"):
        check(_close(torch, g[k], c[k], LM_PREFILL_TOL),
              f"{label} whisper {k} card vs CPU differs by {diffs[k]}")
    check(dec_ok, f"{label} whisper: decode differs from the teacher-forced "
                  f"logits by {dec_diff}")
    check(launches == want_launches,
          f"{label} whisper: the card's loss and prefill launched "
          f"ssd_fwd/flash_attention_fwd {launches} times, expected "
          f"{want_launches}")
    return {"diffs": diffs, "decode_diff": dec_diff, "init_s": init_s}


def whisper_phases(torch):
    """(x) whisper-large-v3 served at full width through
    ``launch.serve.main`` (WHISPER_USERS users on WHISPER_PLEN-token
    streams with the zero frames, ``--personal-subset embed/unembed``, fp32
    then int8, one window apply each), (y) its prefill at
    WHISPER_PREFILL_SHAPES, 2 timed calls each, (z) card against CPU at
    WHISPER_CUT.  Returns (x)'s and (y)'s rows."""
    with timed("(x)"):
        xl, (x_cfg, x_params) = lm_serving_phase(
            torch, "whisper-large-v3", "(x)", subset=WHISPER_SUBSET,
            users=WHISPER_USERS, plen=WHISPER_PLEN)
    with timed("(y)"):
        xprefill = prefill_phase(torch, x_cfg, x_params, "(y)", calls=2,
                                 shapes=WHISPER_PREFILL_SHAPES)
    del x_params
    torch.cuda.empty_cache()
    with timed("(z)"):
        encdec_cpu_parity(torch, "(z)")
    torch.cuda.empty_cache()
    return xl, xprefill


# ---------------------------------------------------------------------------
# phases (m)-(o): the scenario engine and the tuner
# ---------------------------------------------------------------------------

# (m): the scale row of benchmarks/run.py:963-1060 at its full length
SCALE_NS = (1_000, 10_000, 100_000, 1_000_000)
SCALE_WINDOWS = 5
SCALE_WIDTH = 1 << 16            # synthetic per-client delta width
SCALE_SCHED = dict(window_len=30.0, cohort_cap=256, cycles_per_window=8)
SCALE_ORACLE_N = 10_000
# (n): examples/scenario_churn.py:70-85 on the fig2 clients
CHURN_PCFG = dict(option="A", q_local=5, eta=0.002, lam=25.0, inner_steps=3,
                  inner_eta=0.02)
CHURN_ROUNDS = 48
# (o): a 4-arm sweep on the same CNN and churn
TUNE_ROUNDS, TUNE_EVAL_EVERY = 24, 8
# (p): the heap against the stream, around FLRun's "auto" switch at 4096
EVENT_NS = (30, 1_000, 4_096, 10_000, 100_000)
EVENT_COUNT = 10_000


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def scale_spec(n: int):
    from repro_torch.fl.scenario import (Adversarial, Diurnal,
                                         ScenarioSpec, Tier)
    return ScenarioSpec(
        n_clients=n, seed=0,
        tiers=(Tier("fast", 0.5, 0.7), Tier("slow", 0.5, 1.6)),
        diurnal=Diurnal(period=400.0, floor=0.25), dropout=0.02,
        adversarial=Adversarial(frac=0.05, kinds=("scale", "sign_flip")))


def device_kernels(torch, fn) -> dict:
    """The device kernels ``fn()`` launches and their summed device time
    (ms), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_events(torch, prof)
    return {"kernels": len(kernels),
            "device_ms": sum(ms for _, ms in kernels)}


def scale_window(torch, sched, model, base, state, stats):
    """One window of the scale row: the scheduler's cohort corrupts a
    seeded bank (``scale_rows``), which is admitted through the robust clip
    path and applied with one ``apply_admitted_rows``; returns the state."""
    from repro_torch.core import (apply_admitted_rows, bank_row_norms,
                                  mask_rows, robust_admission_weights,
                                  scale_rows)
    from repro_torch.fl.engine import DeltaBank
    ids, _ = sched.next_window()
    fill = len(ids)
    if fill == 0:
        return state
    cap = sched.cohort_cap
    bank = DeltaBank(stacked=base, k=fill, stats=stats["bank"])
    fac = model.corruption_factors(ids)
    vec = np.ones(cap, np.float32)
    vec[:fill] = fac
    stacked = scale_rows(bank.stacked, vec)
    stats["corrupted"] += int(np.sum(fac != 1.0))
    weights, keep, info = robust_admission_weights(
        cap, [(j, 0) for j in range(fill)], bank_row_norms(stacked),
        beta=0.1, count=fill, method="clip")
    stats["clipped"] += info["clipped"]
    stats["applies"] += 1
    if not bool(keep.all()):
        stacked = mask_rows(stacked, keep)
    return apply_admitted_rows(state, stacked, weights, fill,
                               staleness_max=0, staleness_sum=0.0)


def scale_oracle_check(torch, device):
    """The first window at SCALE_ORACLE_N clients against the float64
    EventStream: the cohort is the first cohort_cap first completions, ids
    exactly and times within rel 1e-4, leaving out completions within 1e-3
    of the window's end and within rel 1e-5 of the cap's cut.  Then the
    first 3 windows against the same scheduler on the CPU: ids exactly."""
    from repro_torch.fl.scenario import DeviceScheduler, EventStream, KIND_UP
    spec = scale_spec(SCALE_ORACLE_N)
    window = SCALE_SCHED["window_len"]
    card = DeviceScheduler.from_spec(spec, device=device, **SCALE_SCHED)
    cpu = DeviceScheduler.from_spec(spec, device="cpu", **SCALE_SCHED)
    ids, times = card.next_window()
    first = {}
    for t, i, kind, _, _ in EventStream(spec.build()).events():
        if t >= window:
            break
        if kind == KIND_UP and i not in first:
            first[i] = t
    order = sorted((t, i) for i, t in first.items())
    cap = card.cohort_cap
    cut = order[cap][0] if len(order) > cap else window
    inside = {i: t for t, i in order if t < cut * (1 - 1e-5)
              and abs(t - window) > 1e-3}
    outside = {i for t, i in order if t > cut * (1 + 1e-5)}
    got = dict(zip(ids.tolist(), times.tolist()))
    check(len(inside) > cap // 2, f"(m) oracle: only {len(inside)} certain "
                                  f"completions")
    missing = [i for i in inside if i not in got]
    check(not missing, f"(m) oracle: {len(missing)} certain completions "
                       f"missing from the card's cohort, e.g. {missing[:5]}")
    check(not outside & set(got), "(m) oracle: the card's cohort holds "
                                  "completions past the cap's cut")
    rel = max(abs(got[i] - t) / t for i, t in inside.items())
    check(rel <= 1e-4, f"(m) oracle: arrival times differ by rel {rel}")
    check(bool(np.all(np.diff(times) >= 0)), "(m) cohort not in arrival "
                                             "order")
    cpu_ids, cpu_times = cpu.next_window()
    tdiff = [float(np.max(np.abs(times - cpu_times))) if len(times)
             == len(cpu_times) else float("inf")]
    check(np.array_equal(ids, cpu_ids), "(m) window 1: card and CPU cohorts "
                                        "differ")
    for w in (2, 3):
        a, ta = card.next_window()
        b, tb = cpu.next_window()
        check(np.array_equal(a, b), f"(m) window {w}: card and CPU cohorts "
                                    f"differ")
        tdiff.append(float(np.max(np.abs(ta - tb))) if len(ta) else 0.0)
    check(card.stats == cpu.stats, f"(m) stats card {card.stats} cpu "
                                   f"{cpu.stats}")
    print(f"scale (m) n={SCALE_ORACLE_N}: window 1 against the float64 "
          f"EventStream: {len(inside)} certain completions all in the "
          f"cohort of {len(ids)}, max rel time diff {rel:.3e}; windows 1-3 "
          f"card vs CPU: ids identical, max |time diff| "
          f"{max(tdiff):.3e} s, stats {json.dumps(card.stats)}", flush=True)


def scale_phase(torch, device="cuda"):
    """(m): the DeviceScheduler on the card at SCALE_NS clients, the scale
    row's window pipeline behind it; counts zeroed just before and read
    just after.  Returns ``{"apply_rows": launches}``."""
    from repro_torch.core import init_server_state
    from repro_torch.fl.scenario import DeviceScheduler
    from repro_torch.kernels.fused_update import kernel as K
    scale_oracle_check(torch, device)
    cap = 1 << (SCALE_SCHED["cohort_cap"] - 1).bit_length()
    gen = torch.Generator().manual_seed(0)
    base = {"w": (0.01 * torch.randn(cap, SCALE_WIDTH, generator=gen))
            .to(device)}
    rows = []
    launches = 0
    for n in SCALE_NS:
        t0 = time.perf_counter()
        model = scale_spec(n).build()
        sched = DeviceScheduler(model, device=device, **SCALE_SCHED)
        state = init_server_state(
            {"w": torch.zeros(SCALE_WIDTH, dtype=torch.float32)}, device)
        stats = {"bank": {}, "corrupted": 0, "clipped": 0, "applies": 0}
        setup_s = time.perf_counter() - t0
        # a warm-up window, with the bank pipeline behind it
        state = scale_window(torch, sched, model, base, state, stats)
        stats.update(corrupted=0, clipped=0, applies=0)
        sync(torch, device)
        K.reset_launches()
        t0 = time.perf_counter()
        for _ in range(SCALE_WINDOWS):
            state = scale_window(torch, sched, model, base, state, stats)
        sync(torch, device)
        wall = time.perf_counter() - t0
        n_rows = K.LAUNCHES["apply_rows"]
        launches += n_rows
        check(n_rows == stats["applies"] > 0,
              f"(m) n={n}: apply_rows launched {n_rows} times for "
              f"{stats['applies']} window applies")
        check(torch.isfinite(state.params["w"]).all().item(),
              f"(m) n={n}: params not finite")
        sched_wall = None
        per_window = {}
        if torch.device(device).type == "cuda":
            per_window["scheduler"] = device_kernels(torch, sched.next_window)
            per_window["window"] = device_kernels(torch, lambda: scale_window(
                torch, sched, model, base, state, stats))
            sync(torch, device)
            t1 = time.perf_counter()
            for _ in range(SCALE_WINDOWS):
                sched.next_window()
            sync(torch, device)
            sched_wall = (time.perf_counter() - t1) / SCALE_WINDOWS
        host_mat = stats["bank"].get("host_materializations", 0)
        st = sched.stats
        row = {"n": n, "s_per_window": wall / SCALE_WINDOWS,
               "scheduler_s_per_window": sched_wall,
               "arrivals": st["arrivals"], "dropouts": st["dropouts"],
               "overflow_arrivals": st["overflow_arrivals"],
               "saturated_clients": st["saturated_clients"],
               "corrupted_rows": stats["corrupted"],
               "clipped": stats["clipped"], "host_materializations": host_mat,
               "device_kernels_per_window": per_window,
               "setup_s": setup_s}
        rows.append(row)
        print(f"scale (m) n={n}: {json.dumps(row)}", flush=True)
        check(host_mat == 0, f"(m) n={n}: {host_mat} host materializations")
        check(st["arrivals"] > 0 and stats["corrupted"] > 0,
              f"(m) n={n}: no arrivals or no corrupted rows ({st})")
    n_ratio = rows[-1]["n"] / rows[0]["n"]
    t_ratio = rows[-1]["s_per_window"] / max(rows[0]["s_per_window"], 1e-9)
    print(f"scale (m) sub-linear gate: t_ratio {t_ratio:.3f} <= 0.2 x "
          f"n_ratio {n_ratio:.0f}", flush=True)
    check(t_ratio <= 0.2 * n_ratio, f"(m) s/window grew {t_ratio:.1f}x for "
                                    f"{n_ratio:.0f}x clients")
    return {"apply_rows": launches}


def churn_run(setup, robust, scheduler, device):
    from repro_torch.core import PersAFLConfig
    from repro_torch.fl import FLRun, buffered, strategy
    clients, params, loss, _ = setup
    return FLRun(clients=clients, loss_fn=loss, init_params=params,
                 pcfg=PersAFLConfig(**CHURN_PCFG),
                 delays=churn_spec(len(clients)).build(),
                 strategy=strategy("persafl", option="A"),
                 schedule=buffered(8, robust=robust), batch_size=16, seed=0,
                 scheduler=scheduler, device=device)


def churn_spec(n: int):
    from repro_torch.fl.scenario import Adversarial, ScenarioSpec, Tier
    return ScenarioSpec(
        n_clients=n, seed=0,
        tiers=(Tier("phone", 0.5, 0.7), Tier("iot", 0.5, 1.8)),
        dropout=0.05, adversarial=Adversarial(
            frac=0.1, kinds=("scale", "sign_flip"), magnitude=50.0))


def churn_phase(torch, setup, device="cuda"):
    """(n): the MNIST CNN under churn with adversaries, buffered(8) plain
    and clipped, each run with the stream (``scheduler="device"``) and the
    heap; counts zeroed just before and read just after.  Returns the
    ``apply_rows`` launches."""
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.tree import tree_leaves
    ev = setup[3]
    out = {}
    # the heap and the stream must give the same params bit for bit: the
    # cohort's convolutions take cuDNN's deterministic algorithms here
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # warm-up, untimed: the first cohort calls pick their algorithms
        churn_run(setup, None, "heap", device).run(max_rounds=16)
        K.reset_launches()
        with stacked_applies(K) as stacked:
            for robust in (None, "clip"):
                for scheduler in ("device", "heap"):
                    run = churn_run(setup, robust, scheduler, device)
                    t0 = time.perf_counter()
                    hist = run.run(max_rounds=CHURN_ROUNDS)
                    sync(torch, device)
                    wall = time.perf_counter() - t0
                    out[robust, scheduler] = (run, hist)
                    st = run.stats
                    print(f"churn (n) robust={robust} scheduler={scheduler}"
                          f" {CHURN_ROUNDS} rounds: wall {wall:.3f} s, "
                          f"{wall / CHURN_ROUNDS:.4f} s/round, final acc "
                          f"{ev(run.params):.4f}, finite "
                          f"{finite(torch, run.params)}, stats "
                          f"{json.dumps(st)}", flush=True)
                    check(st["scheduler"] == scheduler,
                          f"(n) ran the {st['scheduler']} scheduler")
                    check(st["corrupted_rows"] > 0,
                          f"(n) robust={robust}: no corrupted rows")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = K.LAUNCHES["apply_rows"]
    check(launches == stacked["planned"] > 0,
          f"(n): apply_rows launched {launches} times for "
          f"{stacked['applies']} stacked applies, {stacked['planned']} "
          f"planned")
    for robust in (None, "clip"):
        (rd, hd), (rh, hh) = out[robust, "device"], out[robust, "heap"]
        check(hd.as_dict() == hh.as_dict(),
              f"(n) robust={robust}: histories differ between the stream "
              f"and the heap")
        diff = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(rd.params), tree_leaves(rh.params)))
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(rd.params), tree_leaves(rh.params))),
              f"(n) robust={robust}: params differ by {diff} between the "
              f"stream and the heap")
        for key in ("corrupted_rows", "robust_clipped", "dropouts"):
            check(rd.stats[key] == rh.stats[key],
                  f"(n) robust={robust}: {key} differs")
    clip = out["clip", "device"][0]
    check(clip.stats["robust_clipped"] > 0, "(n) clip clipped no row")
    check(finite(torch, clip.params), "(n) clip: params not finite")
    print(f"churn (n): stream and heap identical (History, params bit for "
          f"bit) under both flushes; apply_rows {launches} launches for "
          f"{stacked['applies']} stacked applies", flush=True)
    return {"apply_rows": launches}


def tune_phase(torch, setup, device="cuda"):
    """(o): a 4-arm TuneRunner sweep (persafl / fedprox × immediate /
    buffered(8)) on the CNN under the churn of (n), self-stopping with
    default_rules(), journaled; then the same sweep again over the journal,
    which must skip every arm.  Counts zeroed just before and read just
    after the first sweep."""
    from repro_torch.core import PersAFLConfig
    from repro_torch.tune import SweepSpec
    clients, params, loss, ev = setup
    prob = {"clients": clients, "loss_fn": loss, "init_params": params,
            "eval_fn": ev, "pcfg": PersAFLConfig(**CHURN_PCFG),
            "batch_size": 16, "eval_every": TUNE_EVAL_EVERY}
    sweep = SweepSpec(
        strategies=({"name": "persafl", "option": "A"},
                    {"name": "fedprox", "mu": 0.1}),
        schedules=("immediate", "buffered(8)"),
        scenario=churn_spec(len(clients)), seeds=(0,), group="mnist/churn")
    arms = sweep.arms(max_rounds=TUNE_ROUNDS)
    check(len(arms) == 4, f"(o) {len(arms)} arms")
    with tempfile.TemporaryDirectory() as tmp:
        return tune_sweeps(torch, prob, arms, Path(tmp) / "journal.jsonl",
                           device)


def tune_sweeps(torch, prob, arms, journal: Path, device):
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.tune import TuneRunner, default_rules
    K.reset_launches()
    t0 = time.perf_counter()
    with stacked_applies(K) as stacked:
        trials = TuneRunner(lambda arm: prob, journal=str(journal),
                            stop_rule=default_rules(),
                            device=device).run_sweep(arms)
    sync(torch, device)
    wall = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in ("apply_scaled", "apply_rows")}
    for t in trials:
        print(f"tune (o) {t.arm.name}: {t.status} {t.stop_reason or ''} "
              f"rounds {t.rounds} sim_time {t.sim_time:.3f} final acc "
              f"{t.final_acc:.4f} evals {len(t.acc)} wall {t.wall_s:.3f} s "
              f"stats {json.dumps(t.stats)}", flush=True)
        check(t.params_finite or t.status == "stopped",
              f"(o) {t.arm.name}: params not finite")
        check(0.0 <= t.final_acc <= 1.0, f"(o) {t.arm.name}: final acc "
                                         f"{t.final_acc}")
        check(t.host_materializations == 0 or "immediate" in t.arm.schedule,
              f"(o) {t.arm.name}: host materializations")
    # arms that share the seed see the same event timeline: each schedule's
    # two strategies evaluate at the same simulated times (up to the
    # earlier stop, whose final forced eval is left out)
    for sched in ("immediate", "buffered(8)"):
        a, b = [t for t in trials if t.arm.schedule == sched]
        k = min(len(a.times) - (a.status == "stopped"),
                len(b.times) - (b.status == "stopped"))
        check(k >= 2 and a.times[:k] == b.times[:k],
              f"(o) {sched}: eval times differ between strategies "
              f"({a.times} / {b.times})")
        if a.status == b.status == "completed":
            check(a.sim_time == b.sim_time and a.rounds == b.rounds,
                  f"(o) {sched}: run ends differ")
    check(launches["apply_scaled"] > 0, "(o) apply_scaled not launched")
    check(launches["apply_rows"] == stacked["planned"] > 0,
          f"(o) apply_rows launched {launches['apply_rows']} times, "
          f"{stacked['planned']} planned")

    def exploding(arm):
        raise SmokeFailure(f"(o) resumed arm {arm.name} re-executed")
    again = TuneRunner(exploding, journal=str(journal),
                       stop_rule=default_rules(),
                       device=device).run_sweep(arms)
    check(all(t.resumed for t in again)
          and [t.key for t in again] == [t.key for t in trials],
          "(o) the second sweep did not skip every arm")
    print(f"tune (o) sweep of {len(arms)} arms: wall {wall:.3f} s, "
          f"{sum(t.status == 'stopped' for t in trials)} stopped, launches "
          f"{json.dumps(launches)}; resumed sweep skipped all "
          f"{len(again)} arms", flush=True)

    # a rule sure to fire: accuracy never exceeds 1, so the second eval is
    # always short of the first + 2, and the arm stops there, at round
    # 2 * TUNE_EVAL_EVERY, on the timeline its first run saw
    from repro_torch.tune import AccPlateau
    first = trials[0]
    stop = TuneRunner(lambda arm: prob, stop_rule=AccPlateau(
        patience=1, min_delta=2.0), device=device).run_arm(arms[0])
    print(f"tune (o) {stop.arm.name} under AccPlateau(1, 2.0): "
          f"{stop.status} at round {stop.rounds}, sim_time "
          f"{stop.sim_time:.3f}: {stop.stop_reason}", flush=True)
    check(stop.status == "stopped" and (stop.stop_reason or "").startswith(
        "acc_plateau: best of last 1 evals")
        and stop.rounds == 2 * TUNE_EVAL_EVERY,
        f"(o) the sure-fire rule: {stop.status} at round {stop.rounds} "
        f"({stop.stop_reason})")
    check(len(first.times) >= 2 and stop.times == first.times[:2]
          and stop.sim_time == first.times[1],
          f"(o) the stopped arm's evals {stop.times} are not the first two "
          f"of its full run {first.times}")
    return launches


def event_source_phase():
    """(p): the seconds the heap and the EventStream take to give the
    first event and the first EVENT_COUNT events, at EVENT_NS clients,
    under FLRun's default DelayModel and under the scale row's churn.
    Host work only: the two must give the same events, and the phase
    reports the fewest clients from which the stream is the faster."""
    import itertools
    from repro_torch.fl import DelayModel
    from repro_torch.fl.scenario.sched import EventStream, heap_events
    models = {"DelayModel": lambda n: DelayModel(n, seed=0),
              "scale row churn": lambda n: scale_spec(n).build()}
    out = {}
    for label, make in models.items():
        rows = []
        for n in EVENT_NS:
            row, events = {"n": n}, {}
            for src in ("heap", "stream"):
                model = make(n)
                t0 = time.perf_counter()
                gen = heap_events(model, n) if src == "heap" \
                    else EventStream(model).events()
                first = next(gen)
                t1 = time.perf_counter()
                events[src] = [first] + list(
                    itertools.islice(gen, EVENT_COUNT - 1))
                t2 = time.perf_counter()
                row[f"{src}_first_s"] = t1 - t0
                row[f"{src}_s"] = t2 - t0
                row[f"{src}_events_per_s"] = (EVENT_COUNT - 1) / (t2 - t1)
            check(events["heap"] == events["stream"],
                  f"(p) {label} n={n}: the heap and the stream differ")
            row["auto"] = "device" if n >= 4096 else "heap"
            rows.append(row)
            print(f"events (p) {label}: {json.dumps(row)}", flush=True)
        faster = [r["n"] for r in rows if r["stream_s"] < r["heap_s"]]
        out[label] = min(faster) if faster else None
        print(f"events (p) {label}: {EVENT_COUNT} events, the stream is "
              f"the faster from n={out[label]} (of {list(EVENT_NS)}); "
              f"auto switches at 4096", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase (q): the socket transport in front of the server on the card
# ---------------------------------------------------------------------------

# (q1): the serve_transport row of benchmarks/run.py:444-468 at its size
XPORT = dict(d=256, classes=10, rows=32, conns=32, windows=8, reps=3)
XPORT_PCFG = dict(option="C", lam=20.0, inner_steps=200, inner_eta=0.01,
                  beta=0.5)
XPORT_FLUSH_MS, XPORT_MAX_INFLIGHT = 100.0, 128
XPORT_RATIO = 1.5                # the row's limit: reported, not gated here
# the quant bench's wire gate (benchmarks/run.py:806-900): 256 classes, an
# int8 head body >= 3.5x smaller than an fp32 one
WIRE_CLASSES, WIRE_RATIO = 256, 3.5
WIRE_PCFG = dict(option="C", lam=20.0, inner_steps=5, inner_eta=0.05,
                 beta=0.5)
# (q2): mamba2-130m over the socket; its fp32 head (~670 MB) exceeds
# MAX_FRAME_BYTES, embed/unembed (154,460,160 bytes) does not
LISTEN_SUBSET, LISTEN_USERS, LISTEN_SECONDS = "embed/unembed", 4, 30.0
# the child's flush deadline: the users submit together and must make one
# cohort whatever the host's speed (at the default 10 ms a loaded host has
# split them 3 + 1)
LISTEN_FLUSH_MS = 1000.0
LISTEN_START_S = 180.0           # the child's imports and init, at most

# the second OS process of (q1): the port's AsyncTransportClients, one
# connection a user, one request a user a window, an ADVANCE after each
# window (benchmarks/transport_loadgen.py); batches from RandomState(0) as
# there.  Prints one JSON line and saves the first window's heads.
LOADGEN = r"""
import asyncio, json, sys, time
import numpy as np
from repro_torch.serving.transport import AsyncTransportClient
port, conns, windows, reps, d, rows, classes = map(int, sys.argv[1:8])
out = sys.argv[8]
rng = np.random.RandomState(0)
batches = [{"images": rng.randn(rows, d).astype(np.float32),
            "labels": rng.randint(0, classes, rows).astype(np.int32)}
           for _ in range(conns)]

async def drive():
    clients = [await AsyncTransportClient("127.0.0.1", port).connect()
               for _ in range(conns)]
    done = [0]

    async def one(u, lat, keep):
        t0 = time.perf_counter()
        tid = await clients[u].submit(f"user{u}", batches[u])
        head = await clients[u].poll(tid, wait_ms=120_000)
        if head is None:
            raise SystemExit(f"user{u}: poll timed out")
        lat.append(time.perf_counter() - t0)
        done[0] += 1
        if keep is not None:
            keep.update({f"user{u}/{k}": v for k, v in head.items()})

    async def window(lat, keep=None):
        await asyncio.gather(*(one(u, lat, keep) for u in range(conns)))
        await clients[0].advance()

    first = {}
    await window([], first)
    np.savez(out, **first)
    best, lat = float("inf"), []
    for _ in range(reps):
        lat_rep = []
        t0 = time.perf_counter()
        for _ in range(windows):
            await window(lat_rep)
        wall = time.perf_counter() - t0
        if wall < best:
            best, lat = wall, lat_rep
    for c in clients:
        await c.close()
    return {"wall_s": best, "latencies_s": lat, "heads_done": done[0]}

print(json.dumps(asyncio.run(asyncio.wait_for(drive(), 600))), flush=True)
"""


def linear_loss(torch):
    def loss(p, b):
        logp = torch.log_softmax(b["images"] @ p["w"] + p["b"], -1)
        return -torch.mean(logp.gather(-1, b["labels"].long()[..., None]))
    return loss


def xport_batches(n, rows, d, classes, seed=0):
    rng = np.random.RandomState(seed)
    return [{"images": rng.randn(rows, d).astype(np.float32),
             "labels": rng.randint(0, classes, rows).astype(np.int32)}
            for _ in range(n)]


def xport_window(torch, srv, uids, batches, device):
    """One window in-process: every user submits, the queue is flushed,
    every head is gathered, the window closes.  Returns the heads."""
    tickets = [srv.submit(u, b) for u, b in zip(uids, batches)]
    srv.flush()
    heads = [srv.poll(t) for t in tickets]
    sync(torch, device)
    srv.advance_window()
    return heads


def transport_phase(torch, device="cuda"):
    """(q1): the serve_transport row: a TransportServer in front of
    ``PersonalizationServer(device=device)`` driven by XPORT["conns"]
    connections from a second OS process, 1 warm-up window and
    XPORT["windows"] x XPORT["reps"] timed ones, an ADVANCE after each;
    the same windows in-process on a second server; the first window on
    the CPU; then the int8 wire.  Counts zeroed just before the socket
    drive and read just after.  Returns the ``apply_rows`` launches."""
    import asyncio

    from repro_torch.core import PersAFLConfig
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.serving import PersonalizationServer
    from repro_torch.serving.transport import (AsyncTransportClient,
                                               TransportServer, encode_pytree)
    from repro_torch.tree import tree_leaves
    x = XPORT
    d, classes, conns = x["d"], x["classes"], x["conns"]
    loss = linear_loss(torch)
    pcfg = PersAFLConfig(**XPORT_PCFG)
    params = {"w": np.zeros((d, classes), np.float32),
              "b": np.zeros((classes,), np.float32)}
    batches = xport_batches(conns, x["rows"], d, classes)
    uids = [f"user{u}" for u in range(conns)]
    n_windows = 1 + x["windows"] * x["reps"]

    def make(dev):
        return PersonalizationServer(params, loss, pcfg, modes=("C",),
                                     max_pending=conns, device=dev)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # in-process: the serve row's path at the same users and windows
        srv = make(device)
        first = [{k: v.cpu() for k, v in h.items()} for h in
                 xport_window(torch, srv, uids, batches, device)]
        t_inproc = float("inf")
        for _ in range(x["reps"]):
            t0 = time.perf_counter()
            for _ in range(x["windows"]):
                xport_window(torch, srv, uids, batches, device)
            t_inproc = min(t_inproc, time.perf_counter() - t0)
        # where an in-process window's time goes
        profile = profile_shares(torch, lambda: xport_window(
            torch, srv, uids, batches, device)) \
            if torch.device(device).type == "cuda" else None
        # the first window on the CPU (fp32 banking: no code steps, so
        # serving_cpu_parity's tolerance is PARAM_ATOL)
        t0 = time.perf_counter()
        cpu = xport_window(torch, make("cpu"), uids, batches, "cpu")
        cpu_wall = time.perf_counter() - t0
        cpu_diff = max(float((a[k] - b[k]).abs().max())
                       for a, b in zip(first, cpu) for k in a)

        async def drive(out_npz):
            psrv = make(device)
            ts = await TransportServer(psrv, flush_ms=XPORT_FLUSH_MS,
                                       max_inflight=XPORT_MAX_INFLIGHT
                                       ).start()
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", LOADGEN, str(ts.port), str(conns),
                str(x["windows"]), str(x["reps"]), str(d), str(x["rows"]),
                str(classes), out_npz, env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            try:
                out, err = await asyncio.wait_for(proc.communicate(), 600)
            finally:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
                await ts.stop()
            check(proc.returncode == 0, f"(q1) loadgen exited "
                  f"{proc.returncode}: {err.decode()[-2000:]}")
            res = json.loads(out.decode().strip().splitlines()[-1])
            return res, psrv.stats, dict(ts.stats), psrv.ring.stats

        with tempfile.TemporaryDirectory() as tmp:
            npz = str(Path(tmp) / "first.npz")
            K.reset_launches()
            res, st, tst, rst = asyncio.run(drive(npz))
            sync(torch, device)
            launches = K.LAUNCHES["apply_rows"]
            with np.load(npz) as z:
                wire = {k: z[k] for k in z.files}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bitwise = all(np.array_equal(wire[f"{u}/{k}"], h[k].numpy())
                  for u, h in zip(uids, first) for k in h)
    n_req = conns * x["windows"]
    lat_ms = np.asarray(res["latencies_s"]) * 1e3
    head_bytes = len(encode_pytree(first[0]))
    row = {"conns": conns, "windows": x["windows"], "reps": x["reps"],
           "wall_in_process_s": t_inproc, "wall_transport_s": res["wall_s"],
           "req_per_s_in_process": n_req / t_inproc,
           "req_per_s_transport": n_req / res["wall_s"],
           "ratio_vs_in_process": res["wall_s"] / t_inproc,
           "ratio_limit": XPORT_RATIO,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "head_body_bytes": head_bytes,
           "heads_done": res["heads_done"],
           "cohort_calls": st["cohort_calls"],
           "windows_applied": rst["windows"],
           "host_materializations": st["host_materializations"],
           "apply_rows_launches": launches, "transport": tst,
           "first_window_bitwise": bitwise,
           "cpu_first_window_max_abs_diff": cpu_diff,
           "cpu_first_window_wall_s": cpu_wall,
           "profile_in_process_window": profile}
    print(f"transport (q1) {json.dumps(row)}", flush=True)
    check(res["heads_done"] == conns * n_windows,
          f"(q1) {res['heads_done']} heads done of {conns * n_windows}")
    check(st["cohort_calls"] == n_windows,
          f"(q1) {st['cohort_calls']} cohort calls for {n_windows} windows "
          f"(the {conns} submits of a window did not coalesce)")
    check(st["host_materializations"] == 0,
          f"(q1) {st['host_materializations']} host materializations")
    on_card = torch.device(device).type == "cuda"
    check(rst["windows"] == n_windows
          and (launches == n_windows or not on_card),
          f"(q1) apply_rows launched {launches} times for "
          f"{rst['windows']} window applies, expected {n_windows}")
    check(bitwise, "(q1) the first window's heads over the wire differ "
                   "from the in-process server's")
    check(cpu_diff <= PARAM_ATOL, f"(q1) card vs CPU heads differ by "
                                  f"{cpu_diff} > {PARAM_ATOL}")

    # the int8 wire: an int8-banking server at the quant bench's size
    wparams = {"w": np.zeros((d, WIRE_CLASSES), np.float32),
               "b": np.zeros((WIRE_CLASSES,), np.float32)}
    wbatch = xport_batches(2, x["rows"], d, WIRE_CLASSES)

    async def wire_sizes():
        psrv = PersonalizationServer(wparams, loss,
                                     PersAFLConfig(**WIRE_PCFG),
                                     modes=("C",), max_pending=conns,
                                     delta_dtype="int8", device=device)
        ts = await TransportServer(psrv, flush_ms=XPORT_FLUSH_MS).start()
        cq = await AsyncTransportClient("127.0.0.1", ts.port,
                                        codec="int8").connect()
        cf = await AsyncTransportClient("127.0.0.1", ts.port).connect()
        try:
            tq = await cq.submit("uq", wbatch[0])
            tf = await cf.submit("uf", wbatch[1])
            await cf.flush()
            hq = await cq.poll(tq, wait_ms=30_000)
            hf = await cf.poll(tf, wait_ms=30_000)
            codecs = (cq.last_codec, cf.last_codec)
            sizes = {}
            for codec_ok in (True, False):
                h, body = await cq._rpc({"op": "HEAD", "user": "uq",
                                         "subset_ok": True,
                                         "codec_ok": codec_ok})
                sizes[h["codec"]] = len(body)
            stats = await cq.stats()
        finally:
            await cq.close()
            await cf.close()
            await ts.stop()
        return hq, hf, codecs, sizes, stats

    hq, hf, codecs, sizes, wst = asyncio.run(wire_sizes())
    submit = {c: len(encode_pytree(wbatch[0], codec=c))
              for c in ("fp32", "int8")}
    wire_row = {"head_body_bytes": sizes,
                "head_ratio": sizes["fp32"] / sizes["int8"],
                "submit_body_bytes": submit,
                "submit_ratio": submit["fp32"] / submit["int8"],
                "codecs": codecs,
                "host_materializations": wst["host_materializations"]}
    print(f"transport (q1) int8 wire at {d} x {WIRE_CLASSES}: "
          f"{json.dumps(wire_row)}", flush=True)
    check(codecs == ("int8", "fp32"), f"(q1) codecs {codecs}")
    check(all(np.isfinite(v).all() for v in tree_leaves(hq))
          and all(np.isfinite(v).all() for v in tree_leaves(hf)),
          "(q1) int8 server heads not finite")
    check(wire_row["head_ratio"] >= WIRE_RATIO,
          f"(q1) int8 head body only {wire_row['head_ratio']:.3f}x smaller "
          f"than fp32 (< {WIRE_RATIO})")
    check(wst["host_materializations"] == 0,
          "(q1) int8 server: host materializations")
    row["wire"] = wire_row
    return launches, row


def listen_phase(torch, device="cuda", smoke=False):
    """(q2): ``launch/serve.py --arch mamba2-130m --listen 0`` as a child on
    ``device`` with the embed/unembed subset and int8 banking, serving
    LISTEN_SECONDS; this process is the client: LISTEN_USERS users submit
    (the first with ``codec="int8"``), POLL, HEAD, one ADVANCE, STATS, and
    one connection is left open when the child's serving time ends.
    Returns the child's kernel launches and the phase's numbers."""
    import asyncio
    import re

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch.serve import _personalize_len, _user_batch
    from repro_torch.serving.transport import (AsyncTransportClient,
                                               decode_pytree)
    from repro_torch.tree import tree_leaves
    cfg = get_config("mamba2-130m")
    if smoke:
        cfg = reduce_for_smoke(cfg)
    plen = _personalize_len(cfg, LM_PROMPT)
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "mamba2-130m", "--listen", "0", "--personal-subset",
            LISTEN_SUBSET, "--delta-dtype", "int8", "--serve-seconds",
            str(LISTEN_SECONDS), "--requests", str(LISTEN_USERS),
            "--flush-ms", str(LISTEN_FLUSH_MS), "--device", str(device)]
    if smoke:
        argv.append("--smoke")

    async def go():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t_start = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            *argv, env=env, cwd=str(ROOT), stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        clients = []
        try:
            line = (await asyncio.wait_for(proc.stdout.readline(),
                                           LISTEN_START_S)).decode()
            t_line = time.perf_counter()
            m = re.match(r"serving personalization on 127\.0\.0\.1:(\d+) "
                         r"\(wire protocol v1", line)
            check(m is not None, f"(q2) the child printed {line!r}")
            port = int(m.group(1))
            clients = [await AsyncTransportClient(
                "127.0.0.1", port,
                codec="int8" if u == 0 else "fp32").connect()
                for u in range(LISTEN_USERS)]

            async def one(u):
                t0 = time.perf_counter()
                tid = await clients[u].submit(
                    f"user{u}", _user_batch(cfg, u, plen))
                head = await clients[u].poll(tid, wait_ms=60_000)
                return head, time.perf_counter() - t0

            polled = await asyncio.gather(*(one(u)
                                            for u in range(LISTEN_USERS)))
            users = []
            for u, (head, wall) in enumerate(polled):
                c = clients[u]
                check(head is not None, f"(q2) user{u}: poll not done")
                h, body = await c._rpc({"op": "HEAD", "user": f"user{u}",
                                        "subset_ok": True,
                                        "codec_ok": c.codec == "int8"})
                again = decode_pytree(body)
                same = all(np.array_equal(a, b) for a, b in
                           zip(tree_leaves(head), tree_leaves(again)))
                users.append({"user": u, "codec": c.last_codec,
                              "head_codec": h["codec"],
                              "subset": c.last_subset,
                              "submit_to_head_s": wall,
                              "body_bytes": len(body),
                              "head_equals_poll": same,
                              "finite": all(bool(np.isfinite(x).all())
                                            for x in tree_leaves(head))})
            window = await clients[0].advance()
            stats = await clients[0].stats()
            t_work = time.perf_counter() - t_line
            # every client but one closes; the last stays connected
            for c in clients[:-1]:
                await c.close()
            remaining = LISTEN_SECONDS + 10 - (time.perf_counter() - t_line)
            out, err = await asyncio.wait_for(proc.communicate(),
                                              max(remaining, 1.0))
            took = time.perf_counter() - t_line
            return (users, window, stats, proc.returncode, out.decode(),
                    err.decode(), took, t_work, t_line - t_start)
        finally:
            for c in clients:
                await c.close()
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    users, window, stats, rc, out, err, took, t_work, t_boot = \
        asyncio.run(go())
    m = re.search(r"launches (\{.*\})", out)
    launches = json.loads(m.group(1)) if m else {}
    fp32_bytes = [u["body_bytes"] for u in users if u["codec"] == "fp32"]
    int8_bytes = [u["body_bytes"] for u in users if u["codec"] == "int8"]
    row = {"users": users, "window": window,
           "cohort_calls": stats["cohort_calls"],
           "host_materializations": stats["host_materializations"],
           "child_rc": rc, "child_boot_s": t_boot,
           "client_work_s": t_work, "child_exit_after_line_s": took,
           "serve_seconds": LISTEN_SECONDS, "child_launches": launches,
           "body_bytes_fp32": fp32_bytes, "body_bytes_int8": int8_bytes}
    print(f"transport (q2) mamba2-130m --listen: {json.dumps(row)}",
          flush=True)
    if rc != 0:
        print(err[-4000:], file=sys.stderr, flush=True)
    check(rc == 0, f"(q2) the serve child exited {rc}")
    check(took <= LISTEN_SECONDS + 10,
          f"(q2) the child exited {took:.2f} s after its line, with a "
          f"connection open (limit {LISTEN_SECONDS + 10})")
    check(len(users) == LISTEN_USERS and all(
        u["finite"] and u["head_equals_poll"] for u in users),
          "(q2) a head not finite, or HEAD differs from POLL")
    check(all(u["subset"] == [LISTEN_SUBSET] for u in users),
          "(q2) the subset descriptor is not stamped")
    check([u["codec"] for u in users] == ["int8"] + ["fp32"] * (
        LISTEN_USERS - 1) and all(u["codec"] == u["head_codec"]
                                  for u in users),
          f"(q2) codecs {[u['codec'] for u in users]}")
    check(window == 1 and stats["cohort_calls"] == 1
          and stats["host_materializations"] == 0,
          f"(q2) window {window}, stats {stats}")
    # the cohort's loss evaluations: K prox steps and nu's gradient
    want = {"ssd_fwd": cfg.n_layers * (LM_INNER_STEPS + 1),
            "apply_rows_q": 1}
    if torch.device(device).type == "cuda":
        check(all(launches.get(k) == v for k, v in want.items()),
              f"(q2) the child launched {launches}, expected {want}")
    return launches, row


# ---------------------------------------------------------------------------
# phases (T1)-(T3): the training driver, launch/train.py
# ---------------------------------------------------------------------------

# (T1): launch/train.py --preset at its defaults (Option C, 30 clients, Q 10,
# K 10, batch 16); (name, rounds, --eval-every).  paper-cifar is cut from
# 200 rounds to 20, evaluated every 10, and paper-mnist from 200 to 100
# (the script took 1115 s with (M1)-(M3) at 200), for the 1200 s budget: at 200 rounds the two presets took 67.3 + 81.0 s, and their
# 20-round profiles 11.4 + 15.4 s (NVIDIA H100 80GB HBM3 at 700 W).  The
# device's busy share is read from a run of its own of TRAIN_PROFILE_ROUNDS
# rounds, so that the profiler's cost stays out of s/round
TRAIN_PRESETS = (("paper-mnist", 100, 50), ("paper-cifar", 20, 10))
TRAIN_PROFILE_ROUNDS = 5
# (T2): launch/train.py --arch at published width, (B, S) = (8, 512),
# Option C, TRAIN_ROUNDS rounds each at Q and K cut to TRAIN_CUT: at the
# driver's defaults (Q 10, K 10, 110 gradient evaluations a round) a round
# took 27.6-37.2 s (mamba2-130m, host-bound) and 41.5-42.8 s (granite) on
# an NVIDIA H100 80GB HBM3 at 700 W (tools/train_round.py measures the
# defaults)
TRAIN_ARCHS = ("mamba2-130m", "granite-moe-1b-a400m")
TRAIN_ROUNDS = 2
TRAIN_CUT = ("--q", "2", "--inner-steps", "2")
TRAIN_TOKENS = 8 * 512
H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, data sheet
# (T3): make_train_step at TRAIN_PARITY's cut, card against CPU, f32; the
# new params within PARAM_ATOL and delta_norm within TRAIN_NORM_RTOL (f32
# norms of the same deltas summed in other orders)
TRAIN_PARITY = dict(n_layers=2, shape=(2, 128), q_local=2, inner_steps=2)
TRAIN_NORM_RTOL = 1e-5
# the autograd nodes of the port's two kernel Functions' plain backward
# passes, as torch.profiler names them under torch.func
PLAIN_BACKWARD = {"flash_attention_bwd_plain": "FlashAttention",
                  "ssd_bwd_plain": "SSDScan"}


def train_preset_phase(torch):
    """(T1) ``launch.train.main --preset <p> --option C`` at TRAIN_PRESETS'
    rounds and evaluation period, the driver's defaults otherwise, on the
    card: s/round, the accuracy
    series, staleness, the active ratio, ``apply_scaled`` launched once per
    immediate apply (and no stacked apply), finite params; the checkpoint
    read back by the port's ``load_server_state`` equal to the run's state
    bit for bit; the busy share of a run of TRAIN_PROFILE_ROUNDS rounds.
    Returns the ``apply_scaled`` launches by preset."""
    from repro_torch.checkpoint import load_server_state
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    out_dir = ROOT / "build" / "train"
    launches = {}
    for preset, rounds, every in TRAIN_PRESETS:
        argv = ["--preset", preset, "--option", "C", "--rounds",
                str(rounds), "--eval-every", str(every), "--out",
                str(out_dir)]
        K.reset_launches()
        with stacked_applies(K) as stacked:
            t0 = time.perf_counter()
            got = train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = {k: K.LAUNCHES[k] for k in ("apply_scaled", "apply_rows")}
        launches[f"(T1) {preset}"] = n["apply_scaled"]
        rec, state = got.record, got.run.state
        check(finite(torch, state.params), f"(T1) {preset}: params not "
                                           f"finite")
        check(len(rec["acc"]) == rounds // every
              and all(0.0 <= a <= 1.0 for a in rec["acc"]),
              f"(T1) {preset}: accuracy series {rec['acc']}")
        check(n == {"apply_scaled": rounds, "apply_rows": 0}
              and stacked["applies"] == 0,
              f"(T1) {preset}: launches {n}, stacked applies {stacked}: "
              f"expected one apply_scaled launch per immediate apply "
              f"({rounds})")
        back = load_server_state(str(out_dir / f"{preset}_optC"))
        same = all(np.array_equal(np.asarray(a), b.cpu().numpy())
                   for a, b in zip(tree_leaves(back.params),
                                   tree_leaves(state.params)))
        check(same and len(tree_leaves(back.params))
              == len(tree_leaves(state.params))
              and (back.t, back.staleness_sum, back.staleness_max)
              == (state.t, state.staleness_sum, state.staleness_max),
              f"(T1) {preset}: the checkpoint read back differs from the "
              f"run's state")
        prof = profile_shares(torch, lambda: train.main(
            ["--preset", preset, "--option", "C", "--rounds",
             str(TRAIN_PROFILE_ROUNDS), "--eval-every",
             str(TRAIN_PROFILE_ROUNDS), "--out", str(out_dir / "profile")]))
        print(f"(T1) {preset} Option C, {rounds} rounds: wall {wall:.3f} s "
              f"({wall / rounds:.5f} s/round; the driver's wall_s "
              f"{rec['wall_s']:.3f}), acc {rec['acc']} at rounds "
              f"{rec['rounds_series']}, staleness max "
              f"{rec['staleness_max']} mean {rec['staleness_mean']:.4f}, "
              f"mean active ratio {rec['mean_active_ratio']:.4f}, "
              f"launches {json.dumps(n)} (planned {rounds} apply_scaled), "
              f"checkpoint read back equal (t={int(back.t)}); profile of "
              f"{TRAIN_PROFILE_ROUNDS} rounds: busy "
              f"{prof['busy_share']:.4f} of {prof['wall_ms']:.1f} ms, "
              f"{prof['device_kernels']} kernels, top "
              f"{json.dumps(prof['top_ms'][:5])}", flush=True)
    return launches


def plain_backward_ms(torch, cfg, params, batch):
    """Device ms of one gradient evaluation of the LM loss at ``params``,
    and of the part of it inside the plain backward passes of
    ``FlashAttention`` and ``SSDScan`` (their autograd nodes' ranges, read
    through the profiler's function events)."""
    from torch.func import grad
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api

    def g():
        return grad(lambda p, b: api.loss_fn(cfg, p, b))(params, batch)
    g()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g()
        torch.cuda.synchronize()
    total = sum(ms for _, ms in device_events(torch, prof))
    out = {k: 0.0 for k in PLAIN_BACKWARD}
    for e in prof.events():
        if not e.name.startswith("autograd::engine::evaluate_function:"):
            continue
        for key, fn in PLAIN_BACKWARD.items():
            if fn in e.name:
                out[key] += e.device_time_total / 1e3
    return {"grad_eval_device_ms": total, **out}


def train_arch_phase(torch, arch):
    """(T2) ``launch.train.main --arch <arch>`` at published width, (8, 512),
    Option C at TRAIN_CUT's Q and K, TRAIN_ROUNDS rounds: s/round (the
    step, its loss evaluation and the loss's copy to the host), losses,
    ``ssd_fwd`` / ``flash_attention_fwd`` launches against the plan (one
    forward per gradient evaluation, Q·(K+1) of them, and one for the
    round's loss) and ``apply_scaled`` once per round, the peak of device
    memory, model TFLOP/s by the reference's count; then one more round
    under the profiler (busy share, device time by kernel class) and one
    gradient evaluation with the plain attention and SSD backward passes
    named.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import PersAFLConfig
    from repro_torch.data import synthetic_token_batch
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd import kernel as KS
    from repro_torch.launch import steps, train
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    cfg = get_config(arch)
    argv = ["--arch", arch, "--rounds", str(TRAIN_ROUNDS), *TRAIN_CUT,
            "--out", str(ROOT / "build" / "train")]
    d = train.build_parser().parse_args(argv)
    evals = d.q * (d.inner_steps + 1)       # gradient evaluations a round
    _reset_lm_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _lm_launches()
    ssd_kernels = KS.LAUNCHES["ssd_fwd_kernels"]
    applies = K.LAUNCHES["apply_scaled"]
    params = got.params
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    per = lm_forward_launches(cfg)
    plan = tuple(TRAIN_ROUNDS * (evals + 1) * n for n in per)
    check((n_params, len(leaves)) == LM_PARAMS[arch],
          f"(T2) {arch}: {n_params} params in {len(leaves)} leaves")
    check(launches == plan, f"(T2) {arch}: ssd_fwd / flash_attention_fwd "
                            f"launched {launches} times, planned {plan}")
    check(applies == TRAIN_ROUNDS * planned_launches(K, leaves, leaves),
          f"(T2) {arch}: apply_scaled launched {applies} times in "
          f"{TRAIN_ROUNDS} rounds")
    losses = got.record["losses"]
    check(len(losses) == TRAIN_ROUNDS and np.isfinite(losses).all()
          and finite(torch, params), f"(T2) {arch}: losses {losses}")
    flops = 6.0 * cfg.n_active_params * TRAIN_TOKENS * evals
    tflops = [flops / s / 1e12 for s in got.round_s]
    # one more round as the driver runs it, under the profiler
    pcfg = PersAFLConfig(option=d.option, q_local=d.q, eta=d.eta,
                         lam=d.lam, inner_steps=d.inner_steps,
                         maml_mode=cfg.maml_mode)
    step = steps.make_train_step(cfg, pcfg, n_microbatches=1)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             synthetic_token_batch(TRAIN_ROUNDS, 8, 512, cfg.vocab).items()}

    def one_round():
        new, metrics = step(params, params, batch)
        with torch.no_grad():
            return float(api.loss_fn(cfg, new, batch)), \
                float(metrics["delta_norm"])
    prof = profile_shares(torch, one_round, moe=cfg.moe is not None)
    bwd = plain_backward_ms(torch, cfg, params, batch)
    bwd_ms = sum(bwd[k] for k in PLAIN_BACKWARD)
    row = {"rounds": TRAIN_ROUNDS, "wall_s": wall, "round_s": got.round_s,
           "losses": losses, "peak_device_gb": peak_gb,
           "launches": {"ssd_fwd": launches[0],
                        "flash_attention_fwd": launches[1],
                        "apply_scaled": applies},
           "planned": {"ssd_fwd": plan[0], "flash_attention_fwd": plan[1],
                       "apply_scaled": TRAIN_ROUNDS},
           "ssd_fwd_kernels": ssd_kernels,
           "n_active_params": cfg.n_active_params,
           "grad_evals_per_round": evals,
           "model_tflops_per_round": flops / 1e12,
           "model_tflop_per_s": tflops,
           "bf16_peak_share": [t * 1e12 / H100_BF16_FLOPS for t in tflops],
           "profile": prof, "plain_backward": bwd,
           "plain_backward_share_of_grad_eval":
               bwd_ms / bwd["grad_eval_device_ms"],
           "plain_backward_share_of_round_est":
               bwd_ms * evals / prof["busy_ms"]}
    print(f"(T2) {arch} Option C Q={d.q} K={d.inner_steps} (8, 512), "
          f"{TRAIN_ROUNDS} rounds: {json.dumps(row)}", flush=True)
    del got, params, step, batch
    torch.cuda.empty_cache()
    return row


def train_cpu_parity(torch, arch, label):
    """(T3) one ``make_train_step`` round of ``arch`` at TRAIN_PARITY's cut
    (published widths, 2 layers, f32, Option C, Q 2, K 2, (2, 128)), the
    params drawn on the card and copied to the host: the card's new params
    within PARAM_ATOL of the CPU's (and the round's change of them larger
    than PARAM_ATOL, so a no-op or a sign-flipped change fails), its
    ``delta_norm`` within TRAIN_NORM_RTOL; the card's ``ssd_fwd`` /
    ``flash_attention_fwd`` launches one a forward (Q·(K+1) of them) and
    one ``apply_scaled``.  Returns the card's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.core import PersAFLConfig
    from repro_torch.data import synthetic_token_batch
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map
    c = TRAIN_PARITY
    cfg = dataclasses.replace(get_config(arch), n_layers=c["n_layers"],
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        p_gpu = api.init_params(cfg, gen, "cuda")
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    pcfg = PersAFLConfig(option="C", q_local=c["q_local"],
                         inner_steps=c["inner_steps"], eta=0.01, lam=30.0,
                         maml_mode=cfg.maml_mode)
    step = steps.make_train_step(cfg, pcfg, n_microbatches=1)
    batch = synthetic_token_batch(7, *c["shape"], cfg.vocab)
    _reset_lm_launches()
    t0 = time.perf_counter()
    new_g, m_g = step(p_gpu, p_gpu, {k: torch.from_numpy(v).cuda()
                                     for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _lm_launches() + (K.LAUNCHES["apply_scaled"],)
    t0 = time.perf_counter()
    new_c, m_c = step(p_cpu, p_cpu, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    diff = max(float((a.cpu() - b).abs().max())
               for a, b in zip(tree_leaves(new_g), tree_leaves(new_c)))
    moved = max(float((b - p).abs().max())
                for b, p in zip(tree_leaves(new_c), tree_leaves(p_cpu)))
    dn = (float(m_g["delta_norm"]), float(m_c["delta_norm"]))
    fwd = c["q_local"] * (c["inner_steps"] + 1)
    plan = tuple(fwd * n for n in lm_forward_launches(cfg)) + (1,)
    print(f"{label} card vs CPU, {arch} at {c['n_layers']} layers f32, one "
          f"make_train_step round (Option C, Q={c['q_local']}, "
          f"K={c['inner_steps']}, {tuple(c['shape'])}): new params max "
          f"|diff| {diff:.3e} (tol {PARAM_ATOL}), moved {moved:.3e}; "
          f"delta_norm card {dn[0]:.9g} CPU {dn[1]:.9g} (rel "
          f"{abs(dn[0] - dn[1]) / abs(dn[1]):.3e}, tol {TRAIN_NORM_RTOL}); "
          f"card launches ssd_fwd/flash_attention_fwd/apply_scaled "
          f"{launches} (planned {plan}); wall card {card_s:.2f} s CPU "
          f"{cpu_s:.2f} s", flush=True)
    check(diff <= PARAM_ATOL and moved > PARAM_ATOL,
          f"{label} {arch}: new params card vs CPU differ by {diff} "
          f"(moved {moved})")
    check(abs(dn[0] - dn[1]) <= TRAIN_NORM_RTOL * abs(dn[1]),
          f"{label} {arch}: delta_norm card {dn[0]} CPU {dn[1]}")
    check(launches == plan, f"{label} {arch}: launches {launches}, planned "
                            f"{plan}")
    return launches


def training_phases(torch):
    """(T1)-(T3); returns ``launches_train`` by kernel."""
    from repro_torch.kernels.fused_update import kernel as K
    with timed("(T1)"):
        presets = train_preset_phase(torch)
    out = {"apply_scaled": dict(presets), "ssd_fwd": {},
           "flash_attention_fwd": {}}
    with timed("(T2)"):
        for arch in TRAIN_ARCHS:
            row = train_arch_phase(torch, arch)
            for name, n in row["launches"].items():
                if n:
                    out[name][f"(T2) {arch}"] = n
    with timed("(T3)"):
        for arch in TRAIN_ARCHS:
            ssd, flash, applies = train_cpu_parity(torch, arch, "(T3)")
            for name, n in (("ssd_fwd", ssd), ("flash_attention_fwd", flash),
                            ("apply_scaled", applies)):
                if n:
                    out[name][f"(T3) {arch}"] = n
    K.reset_launches()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases (M1)-(M3): the multi-device paths on a one-rank mesh (nccl)
# ---------------------------------------------------------------------------

# (M1): the fig2 setup under buffered(8) for MESH_ROUNDS server rounds,
# Option A at (d)'s eta: every layout maps its rows one at a time, and
# (a)'s Option C (K = 10 prox steps a local step) took 1.5 s a round at 20
# rounds, 3.2 at 8 (the first cohort holds every client; NVIDIA H100 80GB
# HBM3 at 700 W), past the phases' 60 s
MESH_ROUNDS = 20
MESH_OPTION, MESH_ETA = "A", 0.01
# (M1): int8 serving windows on the (1, 1) mesh
MESH_SERVE_WINDOWS = 2
# (M3): mamba2-130m at published width cut to 2 layers, f32, at (2, 128)
MESH_STEP = dict(n_layers=2, shape=(2, 128), q_local=2)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms while the block runs (two runs of
    the same convolutions give the same bits)."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


@contextlib.contextmanager
def engines_mapped():
    """The server's engines built with ``cohort_impl="map"`` while the block
    runs: rows one at a time on one device, the computation the sharded
    engine makes on each rank."""
    from repro_torch.serving import server
    real = server.CohortEngine

    def mapped(*args, **kw):
        return real(*args, **dict(kw, cohort_impl="map"))
    server.CohortEngine = mapped
    try:
        yield
    finally:
        server.CohortEngine = real


def mesh_serve_phase(torch, f_ref):
    """(M2) ``launch.serve.main --arch mamba2-130m --personalize
    --model-axis 1 --coordinator 127.0.0.1:<free port> --num-processes 1
    --process-id 0`` at (f)'s width and flags, fp32: the sharded server on
    the 1x1 ("cohort", "model") mesh (nccl), the group started and
    destroyed by ``serve.main``; against the same command without the
    flags with the server's engines mapping their rows one at a time (what
    the sharded engine does on each rank).  Checks: the same heads and
    tokens bit for bit, no host materialization, ``ssd_fwd`` 24 launches a
    loss evaluation of a row.  (f)'s heads, from a vmapped cohort whose
    bf16 GEMMs round otherwise, are reported beside them.  Returns the
    launches."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.tree import tree_leaves
    argv = ["--arch", "mamba2-130m", "--personalize", "--requests",
            str(LM_USERS), "--tokens", str(LM_TOKENS), "--prompt-len",
            str(LM_PROMPT), "--inner-steps", str(LM_INNER_STEPS),
            "--device", "cuda", "--out", str(ROOT / "build" / "serve")]
    flags = ["--model-axis", "1", "--coordinator",
             f"127.0.0.1:{_free_port()}", "--num-processes", "1",
             "--process-id", "0"]
    runs = {}
    for tag in ("map", "mesh"):
        _reset_lm_launches()
        t0 = time.perf_counter()
        if tag == "map":
            with engines_mapped():
                run = serve.main(argv)
        else:
            run = serve.main(argv + flags)
        wall = time.perf_counter() - t0
        st = run.server.stats
        rows = st["clients"] + st["padding_waste"]
        runs[tag] = {
            "heads": [x.cpu() for x in tree_leaves(run.heads)],
            "tokens": run.out_tokens.cpu(),
            "row": {"main_wall_s": wall,
                    "personalize_flush_s": run.personalize_s,
                    "decode_s": run.decode_s,
                    "cohort_calls": st["cohort_calls"],
                    "host_materializations": st["host_materializations"],
                    "ssd_fwd_launches": _lm_launches()[0],
                    "expected_ssd_fwd": lm_forward_launches(run.cfg)[0]
                    * (LM_INNER_STEPS + 1) * rows,
                    "engine": run.server.engines["C"].cohort_impl,
                    "model_axis": run.record["model_axis"]}}
        del run
    torch.cuda.empty_cache()
    one, two = runs["map"], runs["mesh"]
    same = all(torch.equal(a, b) for a, b in zip(one["heads"],
                                                 two["heads"]))
    same_tokens = bool(torch.equal(one["tokens"], two["tokens"]))
    vs_f = max(float((a - b).abs().max()) for a, b in
               zip(two["heads"], tree_leaves(f_ref["heads"])))
    f_tokens = float((two["tokens"] == f_ref["tokens"]).float().mean())
    print(f"(M2) mamba2-130m serve --model-axis 1 (1x1 mesh, nccl) against "
          f"the same command on one device, rows mapped: heads bit-equal "
          f"{same}, tokens equal {same_tokens}; against (f)'s vmapped "
          f"cohort: heads max |diff| {vs_f:.3e}, tokens {f_tokens:.4f} "
          f"equal; map {json.dumps(one['row'])}; mesh "
          f"{json.dumps(two['row'])}", flush=True)
    check(not dist.is_initialized(),
          "(M2): serve.main left its process group up")
    check(two["row"]["engine"] == "shard_map"
          and one["row"]["engine"] == "map",
          f"(M2): engines {one['row']['engine']} / {two['row']['engine']}")
    check(same and same_tokens,
          "(M2): the sharded server's heads or tokens differ from the "
          "one-device server's")
    for tag, run in runs.items():
        r = run["row"]
        check(r["host_materializations"] == 0,
              f"(M2) {tag}: {r['host_materializations']} host "
              f"materializations")
        check(r["ssd_fwd_launches"] == r["expected_ssd_fwd"],
              f"(M2) {tag}: ssd_fwd launched {r['ssd_fwd_launches']} "
              f"times, expected {r['expected_ssd_fwd']}")
    return {"ssd_fwd": two["row"]["ssd_fwd_launches"]}


def mesh_serving_check(torch, setup, mesh, shardings):
    """(M1) serving: the (e) users under int8 banking, MESH_SERVE_WINDOWS
    windows with stragglers, on one device with rows mapped and on
    ``mesh`` with ``shardings`` (cuDNN deterministic): the same params
    after every window and the same heads, bit for bit; ``apply_rows_q``
    once per contributing bank on the mesh.  Returns its launches."""
    from repro_torch.core import PersAFLConfig
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.serving import PersonalizationServer
    from repro_torch.sharding import ctx
    from repro_torch.tree import tree_leaves
    clients, params, loss, _ = setup
    batches = serve_batches(clients, MESH_SERVE_WINDOWS)
    uids = [f"user{u}" for u in range(len(clients))]
    out = {}
    for tag, kw in (("map", dict(cohort_impl="map")),
                    ("mesh", dict(cohort_impl="shard_map", mesh=mesh,
                                  param_shardings=shardings))):
        srv = PersonalizationServer(params, loss, PersAFLConfig(**SERVE),
                                    max_pending=64, device="cuda",
                                    delta_dtype="int8", modes=("C",), **kw)
        K.reset_launches()
        t0 = time.perf_counter()
        banks, _ = drive_server(torch, srv, batches, MESH_SERVE_WINDOWS)
        wall = time.perf_counter() - t0
        out[tag] = {"launches": K.LAUNCHES["apply_rows_q"],
                    "banks": sum(banks), "wall": wall,
                    "params": [x.cpu() for x in
                               tree_leaves(ctx.gather(srv.params))],
                    "heads": [x.cpu() for x in
                              tree_leaves(srv.stacked_heads(uids))],
                    "hm": srv.stats["host_materializations"]}
    one, two = out["map"], out["mesh"]
    same = all(torch.equal(a, b) for a, b in zip(one["params"],
                                                 two["params"])) \
        and all(torch.equal(a, b) for a, b in zip(one["heads"],
                                                  two["heads"]))
    print(f"(M1) int8 serving, {MESH_SERVE_WINDOWS} windows of "
          f"{len(uids)} users: the (1,1) mesh against one device bit-equal "
          f"{same}; apply_rows_q {two['launches']} launches for "
          f"{two['banks']} banks; s/window {one['wall'] / MESH_SERVE_WINDOWS:.4f}"
          f" / {two['wall'] / MESH_SERVE_WINDOWS:.4f}", flush=True)
    check(same, "(M1) int8 serving: the mesh's params or heads differ")
    # one launch per contributing bank: the CNN's leaves are one table
    want = -(-len(tree_leaves(params)) // K.max_leaves()) * two["banks"]
    check(two["launches"] == want > 0 and two["hm"] == 0,
          f"(M1) int8 serving: apply_rows_q {two['launches']} launches for "
          f"{two['banks']} banks, {two['hm']} host materializations")
    return two["launches"]


def mesh_flrun_phase(torch, setup):
    """(M1) the fig2 setup (MNIST CNN, 30 clients) at MESH_OPTION under
    buffered(8) for MESH_ROUNDS rounds with ``cohort_impl="map"``, with
    ``"shard_map"`` on the 1-D mesh and on the (1, 1) mesh with every leaf's
    last dim on "model", cuDNN deterministic: params bit-equal and the
    timeline equal across the three; ``apply_rows`` once per stacked apply
    (on a one-rank mesh the bank spans no devices: the kernel); the
    sequential mode forced on a sharded bank against the kernel within
    TOLS; s/round of each; then :func:`mesh_serving_check`.  Returns the
    ``apply_rows`` launches by layout, the int8 serving check's
    ``apply_rows_q`` launches and s/round."""
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import NamedSharding, P
    from repro_torch.tree import tree_leaves, tree_map
    m1 = ctx.cohort_mesh()
    m11 = ctx.cohort_model_mesh(1)
    shardings = tree_map(lambda x: NamedSharding(
        m11, P(*([None] * (x.dim() - 1)), "model")), setup[1])
    layouts = {"map": dict(cohort_impl="map"),
               "1-D": dict(cohort_impl="shard_map", mesh=m1),
               "(1,1)": dict(cohort_impl="shard_map", mesh=m11,
                             param_shardings=shardings)}
    out, launches = {}, {}
    with deterministic_cudnn(torch):
        for tag, kw in layouts.items():
            run = fl_run(setup, ("persafl", {"option": MESH_OPTION}),
                         MESH_OPTION, MESH_ETA, ("buffered", 8), "cuda", **kw)
            K.reset_launches()
            with stacked_applies(K) as stacked:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hist = run.run(max_rounds=MESH_ROUNDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches[tag] = K.LAUNCHES["apply_rows"]
            params = ctx.gather(run.params)
            out[tag] = {
                "params": [x.cpu() for x in tree_leaves(params)],
                "timeline": (list(hist.staleness), list(hist.active_times),
                             list(hist.active_ratio), hist.end_time),
                "s_per_round": wall / MESH_ROUNDS,
                "stacked": dict(stacked), "run": run,
                "hm": run.engine.stats["host_materializations"]}
            print(f"(M1) {tag}: Option {MESH_OPTION}, {MESH_ROUNDS} rounds "
                  f"buffered(8), "
                  f"{out[tag]['s_per_round']:.4f} s/round, apply_rows "
                  f"{launches[tag]} launches for {json.dumps(stacked)}, "
                  f"placements "
                  f"{getattr(run.params['fc'][0]['w'], 'placements', None)}",
                  flush=True)
            check(finite(torch, params), f"(M1) {tag}: params not finite")
            check(launches[tag] == stacked["planned"] > 0,
                  f"(M1) {tag}: apply_rows launched {launches[tag]} times, "
                  f"{stacked['planned']} planned")
            check(out[tag]["hm"] == 0, f"(M1) {tag}: host materializations")
    for tag in ("1-D", "(1,1)"):
        check(all(torch.equal(a, b) for a, b in
                  zip(out[tag]["params"], out["map"]["params"])),
              f"(M1) {tag}: params differ from cohort_impl='map'")
        check(out[tag]["timeline"] == out["map"]["timeline"],
              f"(M1) {tag}: timeline differs from cohort_impl='map'")
    # the sequential mode on a sharded bank against rows_kernel
    run = out["(1,1)"]["run"]
    batches = [run._sample(i) for i in range(8)]
    bank = run.engine.update_cohort(run.params, batches)
    w = torch.full((bank.capacity,), 1.0 / 8, device="cuda")
    K.reset_launches()
    want = ops.apply_rows_tree(run.params, bank.stacked, w)
    n_kernel = K.LAUNCHES["apply_rows"]
    got = ops.apply_rows_tree(run.params, bank.stacked, w, mode="seq")
    check(n_kernel > 0 and K.LAUNCHES["apply_rows"] == n_kernel,
          f"(M1) seq: launches {K.LAUNCHES['apply_rows']} (kernel "
          f"{n_kernel})")
    err = max(float((ctx.local(a) - ctx.local(b)).abs().max())
              for a, b in zip(tree_leaves(got), tree_leaves(want)))
    tol = TOLS["apply_rows"]
    ok = all(torch.allclose(ctx.local(a), ctx.local(b), **tol)
             for a, b in zip(tree_leaves(got), tree_leaves(want)))
    print(f"(M1) mode='seq' against rows_kernel on the (1,1) bank "
          f"(capacity {bank.capacity}): max |diff| {err:.3e} (tol {tol})",
          flush=True)
    check(ok, f"(M1) seq against rows_kernel: {err:.3e}")
    with deterministic_cudnn(torch):
        rows_q = mesh_serving_check(torch, setup, m11, shardings)
    K.reset_launches()
    return launches, rows_q, {k: v["s_per_round"] for k, v in out.items()}


def mesh_step_phase(torch):
    """(M3) ``make_cohort_train_step`` on ``make_host_mesh()`` (1x1
    ("data", "model"), nccl) against ``make_train_step``: mamba2-130m at
    published width cut to MESH_STEP's 2 layers, f32, Option A, Q = 2, at
    (2, 128), the same params and batch: bit-equal new params and
    metrics; ``ssd_fwd`` and ``apply_scaled`` launched by both.  Returns
    the cohort step's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import PersAFLConfig
    from repro_torch.data import synthetic_token_batch
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves
    c = MESH_STEP
    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              n_layers=c["n_layers"], dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        params = api.init_params(cfg, gen, "cuda")
    pcfg = PersAFLConfig(option="A", q_local=c["q_local"], eta=0.01)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             synthetic_token_batch(3, *c["shape"], cfg.vocab).items()}
    out = {}
    with deterministic_cudnn(torch):
        for tag, step in (
                ("train", steps.make_train_step(cfg, pcfg, 1)),
                ("cohort", steps.make_cohort_train_step(
                    cfg, pcfg, lmesh.make_host_mesh(), 1))):
            _reset_lm_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = step(params, params, batch)
            torch.cuda.synchronize()
            out[tag] = (new, m, time.perf_counter() - t0,
                        {"ssd_fwd": _lm_launches()[0],
                         "apply_scaled": K.LAUNCHES["apply_scaled"]})
    (p1, m1, s1, n1), (p2, m2, s2, n2) = out["train"], out["cohort"]
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p1), tree_leaves(p2)))
    same_m = all(torch.equal(m1[k], m2[k]) for k in m1)
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(p1), tree_leaves(params)))
    print(f"(M3) mamba2-130m at {c['n_layers']} layers f32 {c['shape']}: "
          f"make_cohort_train_step on the 1x1 mesh {s2:.3f} s, "
          f"make_train_step {s1:.3f} s; bit-equal params {same}, metrics "
          f"{same_m}, moved {moved:.3e}; launches {json.dumps(n2)} "
          f"(train step {json.dumps(n1)})", flush=True)
    check(same and same_m, "(M3): the cohort step differs from the train "
                           "step on a one-rank mesh")
    check(moved > 0.0, "(M3): the step did not move the params")
    check(n2 == n1 and n2["ssd_fwd"] > 0 and n2["apply_scaled"] == 1,
          f"(M3): launches {n2} (train step {n1})")
    return n2


def mesh_phases(torch, setup, f_ref):
    """(M1)-(M3); returns ``launches_mesh`` by kernel."""
    import torch.distributed as dist

    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.sharding import ctx
    with timed("(M2)"):
        m2 = mesh_serve_phase(torch, f_ref)
    ctx.init_distributed(coordinator=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device="cuda",
                         timeout_s=120)
    try:
        with timed("(M1)"):
            m1, rows_q, s_round = mesh_flrun_phase(torch, setup)
        with timed("(M3)"):
            m3 = mesh_step_phase(torch)
    finally:
        ctx.reset_mesh_cache()
        dist.destroy_process_group()
    print(f"(M1) s/round {json.dumps(s_round)}", flush=True)
    K.reset_launches()
    torch.cuda.empty_cache()
    return {"apply_rows": {f"(M1) {k}": v for k, v in m1.items()},
            "apply_rows_q": {"(M1) int8 serving (1,1)": rows_q},
            "ssd_fwd": {"(M2)": m2["ssd_fwd"], "(M3)": m3["ssd_fwd"]},
            "apply_scaled": {"(M3)": m3["apply_scaled"]}}


def run_phases(torch):
    """Every phase in order, on the card; returns the card's line and
    the ``kernels`` list.  Raises SmokeFailure at the first failed
    check."""
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all(KERNEL_LIBS)
    print(f"build ({len(paths)} nvcc in parallel): "
          f"{time.perf_counter() - t0:.2f} s "
          f"{[p.name for p in paths]}", flush=True)
    for path in paths:
        log = path.with_suffix(".log")
        if log.is_file():
            print(log.read_text().strip(), flush=True)

    setup = fig2_setup(torch)
    from repro_torch.tree import tree_leaves
    cnn_shapes = [tuple(x.shape) for x in tree_leaves(setup[1])]
    mshapes = lm_leaf_shapes("mamba2-130m")
    zshapes = lm_leaf_shapes("zamba2-1.2b")
    gshapes = lm_leaf_shapes("gemma2-2b")
    ushapes = lm_leaf_shapes("granite-moe-1b-a400m")
    wshapes = lm_leaf_shapes("whisper-large-v3")
    for arch, shapes in (("gemma2-2b", gshapes),
                         ("granite-moe-1b-a400m", ushapes),
                         ("whisper-large-v3", wshapes)):
        check((sum(int(np.prod(sh)) for sh in shapes), len(shapes))
              == LM_PARAMS[arch],
              f"{arch}: {len(shapes)} leaves of the config's shapes")
    # zamba2's personal subset: embed/unembed and the 9 shared leaves;
    # gemma2's, granite's and whisper's: embed/unembed (whisper's is its
    # 15th leaf, after the decoder's 13 and embed/tok)
    with timed("kernels"):
        results = kernel_phase(torch, cnn_shapes, (
            ("mamba2-130m 12 leaves", mshapes),
            ("zamba2-1.2b shared,embed/unembed 10 leaves",
             [zshapes[1]] + zshapes[12:]),
            ("gemma2-2b embed/unembed 1 leaf", [gshapes[1]]),
            ("granite-moe-1b-a400m embed/unembed 1 leaf", [ushapes[1]]),
            ("whisper-large-v3 embed/unembed 1 leaf", [wshapes[14]])))
    lm_trees = []
    for arch, shapes in (("mamba2-130m", mshapes), ("zamba2-1.2b", zshapes)):
        n_params = sum(int(np.prod(sh)) for sh in shapes)
        check((n_params, len(shapes)) == LM_PARAMS[arch],
              f"{arch}: {n_params} params in {len(shapes)} leaves")
        lm_trees.append((f"{arch} {len(shapes)} leaves f32", shapes))
    with timed("local steps and leaf tables"):
        local_rows, local_launches = local_step_phase(torch, cnn_shapes,
                                                      lm_trees)
        results.update(local_rows)
        for name, rows in table_tree_phase(torch).items():
            results[name] += rows
    with timed("ssd_fwd"):
        results["ssd_fwd"] = ssd_kernel_phase(torch)
    with timed("flash_attention_fwd"):
        results["flash_attention_fwd"] = flash_kernel_phase(torch)
    with timed("flash_attention_fwd non-causal and cross-length"):
        results["flash_attention_fwd"] += flash_cross_phase(torch)
    imm_ms = immediate_apply_ms(torch, setup[1])
    print(f"immediate apply as the main path runs it (H2D copy of one "
          f"host row + {len(cnn_shapes)} launches): {imm_ms:.4f} ms",
          flush=True)

    with timed("(a)-(d)"):
        launches, hists = main_path(torch, setup)
        profile_training(torch, setup)
        cpu_parity(torch, setup, hists)
    with timed("(e)"):
        serve_launches, _ = serving_phase(torch, setup)
    with timed("(f)-(h)"):
        f_ref = {}
        lm, (lm_cfg, lm_params) = lm_serving_phase(torch, "mamba2-130m",
                                                   "(f)", ref_out=f_ref)
        prefill = prefill_phase(torch, lm_cfg, lm_params, "(g)")
        del lm_params
        torch.cuda.empty_cache()
        lm_cpu_parity(torch, "mamba2-130m", 2, "(h)")
    with timed("(i)-(k)"):
        zl, (z_cfg, z_params) = lm_serving_phase(
            torch, "zamba2-1.2b", "(i)", subset=ZAMBA_SUBSET)
        zprefill = prefill_phase(torch, z_cfg, z_params, "(j)")
        del z_params
        torch.cuda.empty_cache()
        lm_cpu_parity(torch, "zamba2-1.2b", 6, "(k)", subset=ZAMBA_SUBSET)
    with timed("(l)"):
        base_launches = baselines_phase(torch, setup)
    with timed("(m)-(p)"):
        scenario_launches = {"(m)": scale_phase(torch),
                             "(n)": churn_phase(torch, setup),
                             "(o)": tune_phase(torch, setup)}
        event_source_phase()
    with timed("(q)"):
        rows_launches, _ = transport_phase(torch)
        listen_launches, _ = listen_phase(torch)
    # the transport path's counts: (q1)'s window applies in this process,
    # (q2)'s cohort call and window apply in the serve child
    transport_launches = {"apply_rows": {"(q1)": rows_launches},
                          "apply_rows_q": {
                              "(q2)": listen_launches["apply_rows_q"]},
                          "ssd_fwd": {"(q2)": listen_launches["ssd_fwd"]}}
    with timed("(r)-(t)"):
        gl, gprefill = gemma2_phases(torch)
    with timed("(u)-(w)"):
        ul, uprefill = moe_phases(torch)
    with timed("(x)-(z)"):
        xl, xprefill = whisper_phases(torch)
    with timed("(T1)-(T3)"):
        train_launches = training_phases(torch)
    with timed("(M1)-(M3)"):
        mesh_launches = mesh_phases(torch, setup, f_ref)
    del f_ref

    kernels = []
    main_shapes = {"ssd_fwd": SSD_MAIN_SHAPE,
                   "flash_attention_fwd": FLASH_MAIN_SHAPE}
    for name, rows in results.items():
        # the main path's shape comes first: the CNN's leaves for the
        # server-apply kernels, the (f) cohort (4 users x 128 tokens, bf16
        # activations) for ssd_fwd, the (i) cohort for flash_attention_fwd
        main = rows[0] if name not in main_shapes else next(
            r for r in rows if r["shape"] == main_shapes[name])
        if name == "ssd_fwd":
            # serving phase (f) is ssd_fwd's main path
            n = lm["fp32"]["ssd_fwd_launches"]
        elif name == "flash_attention_fwd":
            # serving phase (i) is flash_attention_fwd's main path
            n = zl["fp32"]["flash_attention_fwd_launches"]
        elif name in LOCAL_STEPS:
            # the tree fronts are the local steps' main path
            n = local_launches[name]
        else:
            # apply_rows_q runs on the serving paths (e), (f) and (i) only,
            # (e)'s count here; the others' counts are those of training
            # runs (a)-(d)
            n = launches.get(name, serve_launches.get(name))
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": n,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "shapes": rows}
        if name in TABLE_KERNELS:
            entry["foreach_ms"] = main.get("foreach_ms")
        if name in transport_launches:
            entry["launches_transport"] = transport_launches[name]
        if name in train_launches:
            # the training driver's runs (T1)-(T3)
            entry["launches_train"] = train_launches[name]
        if name in mesh_launches:
            # the multi-device paths on a one-rank mesh, (M1)-(M3)
            entry["launches_mesh"] = mesh_launches[name]
        if name == "ssd_fwd":
            entry["design_bytes"] = main["design_bytes"]
            entry["kernels_per_call"] = main["kernels_per_call"]
            entry["launches_int8"] = lm["int8"]["ssd_fwd_launches"]
            entry["launches_zamba2"] = {
                k: v["ssd_fwd_launches"] for k, v in zl.items()}
            entry["launches_prefill_per_call"] = {
                k: v["ssd_fwd_launches_per_call"] for k, v in prefill.items()}
            entry["launches_zamba2_prefill_per_call"] = {
                k: v["ssd_fwd_launches_per_call"]
                for k, v in zprefill.items()}
        elif name == "flash_attention_fwd":
            entry["launches_int8"] = zl["int8"]["flash_attention_fwd_launches"]
            entry["launches_prefill_per_call"] = {
                k: v["flash_attention_fwd_launches_per_call"]
                for k, v in zprefill.items()}
            # gemma2-2b: (r)'s serving runs and (s)'s prefill calls
            entry["launches_gemma2"] = {
                k: v["flash_attention_fwd_launches"] for k, v in gl.items()}
            entry["launches_gemma2_prefill_per_call"] = {
                k: v["flash_attention_fwd_launches_per_call"]
                for k, v in gprefill.items()}
            # granite-moe-1b-a400m: (u)'s serving runs and (v)'s prefill
            entry["launches_granite"] = {
                k: v["flash_attention_fwd_launches"] for k, v in ul.items()}
            entry["launches_granite_prefill_per_call"] = {
                k: v["flash_attention_fwd_launches_per_call"]
                for k, v in uprefill.items()}
            # whisper-large-v3: (x)'s serving runs (96 a loss evaluation,
            # 32 for the decode cache's encoder) and (y)'s prefill calls
            entry["launches_whisper"] = {
                k: v["flash_attention_fwd_launches"] for k, v in xl.items()}
            entry["launches_whisper_per_evaluation"] = {
                k: v["flash_attention_fwd_launches_per_evaluation"]
                for k, v in xl.items()}
            entry["launches_whisper_prefill_per_call"] = {
                k: v["flash_attention_fwd_launches_per_call"]
                for k, v in xprefill.items()}
        elif name not in LOCAL_STEPS:
            entry["launches_fig2_baselines"] = base_launches.get(name, 0)
            entry["launches_scenario"] = {
                label: counts.get(name, 0)
                for label, counts in scenario_launches.items()}
            entry["launches_serving"] = serve_launches.get(name, 0)
            entry["launches_lm_window_apply"] = {
                label: sum(v["window_apply_launches"] for v in runs.values()
                           if v["window_apply_kernel"] == name)
                for label, runs in (("(f)", lm), ("(i)", zl), ("(r)", gl),
                                    ("(u)", ul), ("(x)", xl))}
        kernels.append(entry)
    kernels[0]["immediate_apply_ms"] = imm_ms
    return card, kernels


def main() -> int:
    # compiled yardsticks (flex_attention) keep their caches in the
    # checkout's build directory
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, kernels = run_phases(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
