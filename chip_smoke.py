#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds every hand-written kernel from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, drives the port's main paths through their entry
points and checks what comes out:

  (a)  flash attention vs its plain version (incl. qwen2's causal GQA-7
       prefill shape and phase (q)'s gemma2, nemotron and whisper
       shapes), timed;
  (a2) decode attention and the fused sampling epilogue vs their plain
       versions at qwen2-7b's decode shapes and phase (q)'s, timed;
  (a3) the int8, paged and paged-int8 decode-attention kernels vs their
       plain versions at qwen2-7b's decode shape (timed, beside the dense
       kernel at the same logical shape) and on edge cases;
  (a4) the partials decode-attention kernel (one sequence shard's
       unnormalised softmax state) vs its plain version on every shard of
       caches cut into 1, 2 and 4 shards, the merged shards vs the dense
       kernel, timed per shard;
  (b)  the paper's offline batch job on the full-width ``distilbert-imdb``
       encoder, monolithic and then parallel;
  (c)  generative serving on the full-width ``qwen2-7b`` (random weights):
       continuous batching of 24 requests over 8 slots, greedy, then with
       fused sampling, then with host sampling;
  (d)  the orchestrated generation job under injected faults at full
       width and reduced depth;
  (e)  the example's entry point as a user runs it on the card
       (``python -m repro_torch.examples.serve_cluster``, one rank of its
       seq-shard mesh), whose sizes phases (c), (d) and (g) share: its
       greedy streams equal (g)'s and its job's tokens (d)'s;
  (f)  paged and int8 serving on the full-width ``qwen2-7b``: 24 requests
       in three groups sharing a 448-token prefix, dense int8, paged bf16,
       paged int8 and paged int8 with fused sampling, against a dense
       bf16 run; prefix sharing, copy-on-write after a fork, int8 vs bf16
       teacher-forced, decode round times;
  (g)  sequence-sharded serving on the full-width ``qwen2-7b``:
       ``Engine(mesh=(1, 1), seq_shard=True)`` behind the batcher, greedy
       and sampled (the partials kernel every round, the sampling kernel
       when sampled, nothing else), then
       on tamed q/k against the dense kernel path, and a decode round;
  (h)  the same mesh path on ranks that share the card (spawned
       processes, gloo): two ranks at full width and 8 layers, four at 2;
       streams bit-identical on every rank, decode round and all_reduce
       time.
  (i)  the paper's Fig. 2: ``benchmarks.fig2.measure_real_per_item`` on
       the full-width ``distilbert-imdb`` (flash kernel), the sweep over
       the paper's batch sizes with its constants (every claim must hold)
       and again at the card's per-item time (printed, not gated);
  (j)  the router (``launch.serve.run_router``) on the full-width
       ``qwen2-7b`` with tamed q/k: the four default policies, crashes,
       paged, fused sampling, measured time; streams held to one batcher's;
  (k)  the round-time calibration (``launch.serve.calibrate``) fitted from
       the card's own rounds, then a router pass on the calibrated clock;
  (l)  the HTTP front door through ``launch.serve.run_http``: 24
       concurrent streaming clients, three replicas' worth, /metrics,
       /healthz and the trace report;
  (m)  ``launch.serve.main`` as a user runs it, with no ``--device``:
       ``--router``, ``--calibrate`` and ``--http`` at the smoke config
       ``main`` serves.
  (n)  the batch DAG (``launch.serve.run_batch_dag``) on the full-width
       ``qwen2-7b`` at 8 of its 28 layers, at the reference CLI's
       defaults with 64-token prompts:
       monolithic, parallel, the chaos ladder, a spot mix and all-spot,
       one digest, equal to one batcher's greedy streams; round times and
       a calibrated mono/parallel pair;
  (o)  training the full-width ``distilbert-imdb`` (60 AdamW steps), remat
       and microbatching against the plain step, the trained classifier
       through the flash kernel and the plain path, phase (b)'s job on it,
       and ``examples.sentiment_case_study.main``;
  (p)  ``launch.train`` and ``examples.train_100m`` as a user runs them,
       crashed and resumed bit for bit, and the "pod" step with int8
       gradients on two ranks sharing the card;
  (q)  the remaining model families, random weights from a seed: (q1)
       ``gemma2-27b`` at full width and depth (the window and softcap
       kernel paths, sampling at a 256 000 vocabulary) greedy and fused
       sampled, held to the plain path; (q2) ``qwen2-moe-a2.7b`` dense
       and paged, and its three MoE dispatches on one prefill; (q3)
       ``mamba2-130m`` (no attention), streams against each request
       alone; (q4) ``nemotron-4-340b`` (head_dim 192) and (q5)
       ``grok-1-314b`` at full width and 2 layers; (q6) the jamba hybrid
       at smoke width; (q7) ``whisper-base``: 1 500 encoder frames, then
       decode steps whose cross-attention runs flash at S 1;
  (r)  tensor-parallel params and a data axis on ranks sharing the card
       (spawned processes, gloo), tamed q/k, each layout held to the
       one-rank engine on the same params and requests: (r1)
       ``launch.serve --mesh 2x2 --full-width`` on ``distilbert-imdb`` in
       its offline mode; (r2) ``qwen2-7b``, all 28 layers, 8 requests
       through ``ContinuousBatcher`` on (1, 2), (1, 4), (2, 1), (2, 2) and
       (2, 2) seq-sharded, sampled on (2, 1) and (1, 2); (r3)
       ``qwen2-moe-a2.7b`` at 6 of its 24 layers, its scatter dispatch
       grouped per data shard on (2, 1) and its experts split on (1, 2);
  (s)  the ZeRO-3 layouts ("fsdp", "fsdp_tp") on (r)'s spawns: training
       held to one rank between a sound twin and a planted fault, and
       qwen2-7b served under "fsdp_tp";
  (t)  SSM and encoder-decoder models under a mesh and replicas on mesh
       slices, on (r)'s spawns, each held to one rank: (t1)
       ``whisper-base`` at full width on (2, 2) "tp" (frames encoded at
       admission, greedy and fused sampled) and trained under "fsdp_tp"
       (2, 2) with (s)'s bounds; (t2) ``mamba2-130m`` on (1, 2) "tp" and
       (2, 2) "fsdp_tp"; (t3) the smoke jamba on (1, 2); (t4) qwen2-7b,
       all 28 layers, a ``Router`` over ``ReplicaPool(mesh_slices=2)`` on
       (2, 2) (two (1, 2) "tp" slices computing concurrently), on the
       modeled and the measured clock, then ``launch.serve --router
       --mesh 2x2 --mesh-slices 2`` as a user types it;
  (u)  the port's last modules: (u1) qwen2-7b, all 28 layers, served
       through the HTTP front door on (r)'s four ranks as a (2, 2) "tp"
       mesh (rank 0 binds the port and ticks every rank's router), greedy
       and fused sampled, held to one rank's front door, then ``launch.serve
       --http --mesh 2x2`` as a user types it; (u2) qwen2-7b at 8 layers on
       a ("pod", "data", "model") (2, 2, 1) mesh, rows cut over both data
       axes, held to one rank; (u3) ``launch.train --arch`` mamba2-130m and
       qwen2-moe-a2.7b beside (p)'s runs, crashed and resumed bit for bit;
       (u4) ``launch.dryrun`` cells of the production mesh on the host's
       CPU beside phases (q)-(t), the card never initialised there.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Any failed phase raises, so the script exits non-zero and
prints no result line; so does a machine with no CUDA device.

Usage (on a machine with one NVIDIA H100 and the CUDA toolkit):
  python3 chip_smoke.py

(``chip_smoke.py --rank-worker SPEC`` is one rank of phase (h),
``chip_smoke.py --pod-worker SPEC`` one of phase (p) and ``chip_smoke.py
--tp-worker SPEC`` one of phase (r), started by the script itself.)

Output: the card's ``name, power.limit`` line, the build time, one line per
kernel check and per phase (with its seconds), a ``{"kernels": [...]}``
JSON line and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import atexit
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# deterministic cuBLAS for the training phases' bit-for-bit checks ((o),
# (p)): the setting must be in place before the process's first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import fig2  # noqa: E402
from repro_torch.core import LatencyModel  # noqa: E402
from repro_torch.core.simulator import CaseStudyConfig  # noqa: E402
from repro_torch.data import TrainLoader, imdb_reviews  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    sentiment_case_study, serve_cluster)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import \
    fused_sampling as fs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.quant import \
    quantize_kv  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_partials_ref, decode_attention_quant_ref,
    decode_attention_ref,
    paged_decode_attention_quant_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_from_env, make_host_mesh, rank_env, spawn_ranks)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.serve import run_offline  # noqa: E402
from repro_torch.models import RunConfig, build as build_model  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
from repro_torch.models.transformer import Cache, PagedCache  # noqa: E402
from repro_torch.obs import lint_prometheus  # noqa: E402
from repro_torch.router import (  # noqa: E402
    TRAFFIC, CalibratedLatencyModel, EventRouter,
    QueueDepthPolicy, Replica, ReplicaConfig, ReplicaPool, Router,
    make_requests)
from repro_torch.serving import (  # noqa: E402
    ContinuousBatcher, Engine, PageAllocator, Request)
from repro_torch.tools import trace_report  # noqa: E402
from repro_torch.training import checkpoint as train_checkpoint  # noqa: E402
from repro_torch.training import optimizer, train_step  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_leaves, tree_leaves_with_path, tree_map)

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet, dense rates): the least time a call could take is the larger of
# its bytes over HBM bandwidth and its FLOPs over the tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel vs plain version: the reference kernel test's own tolerances
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# Kernel path vs plain attention, full model in bf16. The reference's init
# draws the (d_model, heads, head_dim) attention weights with fan_in = heads,
# so at full width the random model's attention logits have a std near 63:
# the softmax is close to an argmax, and any two correct fp32 attention
# implementations part ways over six layers. So the check is relative:
#  * per layer, on the same input, the attention sublayer through the kernel
#    and through the plain path agree to a relative RMS error of LAYER_RTOL
#    (bf16 rounding gives about 1e-3; a wrong kernel gives about 1);
#  * the kernel path's logits are no farther from a float64-attention
#    reference than NOISE_FACTOR times the plain fp32 path's (plus
#    LOGIT_FLOOR), and its labels differ from that reference only where the
#    reference's logit gap is below the same bound: a near-tie at the
#    measured noise level.
LAYER_RTOL = 1e-2
NOISE_FACTOR = 2.0
LOGIT_FLOOR = 0.05
# Phase (f): two serving paths on the same rows, teacher-forced (dense vs
# paged, bf16 vs int8), differ by where and how the prompt's K/V were
# computed and stored; their logits must agree to this relative RMS (a
# wrong page or scale gives about 1). Measured on an H100: 0.007 for the
# dense kernel vs plain paths, 0.012 at most between the serving paths.
PATH_RTOL = 0.05
# gemma2's window and softcap cases: randn q and k give scores of std 1,
# which softcap 50 moves by at most 0.017, and a window edge 64 positions
# off moves a row's output by less than bf16's absolute tolerance. So
# there q is scaled by SHARP_Q (a power of two: exact in bf16), which
# puts the scores at std 32 and their tails past the cap; the kernel is
# held to its plain version by relative RMS (SHARP_RTOL), over all rows
# and over the rows a window 64 positions off would cut; and the same
# kernel called with each planted fault (`sharp_faults`: the softcap or
# the window dropped, the window 64 positions short or long) must break
# that bound, or the check is blind and the phase fails.
SHARP_Q = 32.0
SHARP_RTOL = LAYER_RTOL
SHARP_CASES = ("gemma2_prefill_window_softcap", "gemma2_window_softcap")

# main path: distilbert-imdb at full width, seq 512, batches of 32
MAIN = dict(n_items=512, seq_len=512, batch_size=32, concurrency=8, seed=0)
# (name, b, s, t, h, kv, d, causal, window, softcap, dtype)
CASES = [
    ("main_path_bidir", 32, 512, 512, 12, 12, 64, False, None, None,
     torch.bfloat16),
    ("causal", 4, 512, 512, 12, 12, 64, True, None, None, torch.bfloat16),
    ("window", 4, 512, 512, 12, 12, 64, True, 128, None, torch.bfloat16),
    ("softcap", 4, 512, 512, 12, 12, 64, False, None, 30.0,
     torch.bfloat16),
    ("gqa_4", 4, 256, 256, 16, 4, 128, True, None, None, torch.bfloat16),
    ("ragged_pad", 3, 300, 445, 8, 2, 64, False, None, None,
     torch.bfloat16),
    ("fp32", 2, 200, 200, 4, 2, 32, True, None, None, torch.float32),
    ("tiny", 2, 7, 5, 2, 1, 16, False, None, None, torch.bfloat16),
    # qwen2-7b's prefill: causal, RoPE'd q/k, GQA 7, head_dim 128
    ("qwen2_prefill_gqa7", 1, 512, 512, 28, 4, 128, True, None, None,
     torch.bfloat16),
    # phase (n)'s prefill stage and admissions: one 64-token prompt
    ("dag_prefill", 1, 64, 64, 28, 4, 128, True, None, None, torch.bfloat16),
    # phase (o)'s held-out set, classified in one batch by distilbert-imdb
    ("trained_classify_bidir", 256, 128, 128, 12, 12, 64, False, None, None,
     torch.bfloat16),
    # phase (q): gemma2-27b's local-layer prefill of a 4 608-token prompt
    # (window 4096, softcap 50, GQA 2), nemotron-4-340b's head_dim 192
    # (GQA 12), whisper-base's cross-attention of one decoder row over its
    # 1 500 encoder frames (S 1 of a 64-row tile, T no multiple of 64)
    ("gemma2_prefill_window_softcap", 1, 4608, 4608, 32, 16, 128, True, 4096,
     50.0, torch.bfloat16),
    ("nemotron_prefill_d192", 1, 512, 512, 96, 8, 192, True, None, None,
     torch.bfloat16),
    ("whisper_cross_s1", 1, 1, 1500, 8, 8, 64, False, None, None,
     torch.bfloat16),
    # phase (r)'s local heads: qwen2-7b's admissions (64-256 tokens) on a
    # "model" axis of 2 (14 q over 2 kv heads) and of 4 (a GQA group of 7
    # over one kv head), qwen2-moe's (8, 256) prefill on 2 (8 of 16 heads),
    # and distilbert-imdb's batches of 32 classified on 6 of its 12 heads,
    # whole or as one data shard's 16 rows
    ("tp_qwen2_prefill_14_2", 1, 256, 256, 14, 2, 128, True, None, None,
     torch.bfloat16),
    ("tp_qwen2_prefill_7_1", 1, 256, 256, 7, 1, 128, True, None, None,
     torch.bfloat16),
    ("tp_qwen2_prefill_7_1_s64", 1, 64, 64, 7, 1, 128, True, None, None,
     torch.bfloat16),
    ("tp_moe_prefill_8_8", 8, 256, 256, 8, 8, 128, True, None, None,
     torch.bfloat16),
    ("tp_distilbert_bidir_6_6", 32, 128, 128, 6, 6, 64, False, None, None,
     torch.bfloat16),
    ("tp_distilbert_bidir_6_6_b16", 16, 128, 128, 6, 6, 64, False, None,
     None, torch.bfloat16),
    # phase (t)'s local heads: whisper-base on (2, 2) (4 of its 8 heads a
    # rank), an admission's encoder over its 1 500 frames (bidirectional)
    # and a round's cross-attention of one data shard's 2 decoder rows over
    # them; jamba's smoke attention layer on 2 (2 q over 1 kv head, D 16)
    ("t_whisper_encoder_bidir_4_4", 1, 1500, 1500, 4, 4, 64, False, None,
     None, torch.bfloat16),
    ("t_whisper_cross_s1_4_4", 2, 1, 1500, 4, 4, 64, False, None, None,
     torch.bfloat16),
    ("t_jamba_smoke_2_1", 1, 16, 16, 2, 1, 16, True, None, None,
     torch.bfloat16),
]
# the flash cases that are timed: the offline main path, one qwen2-7b
# prefill admission and phase (q)'s three shapes
TIMED_FLASH = ("main_path_bidir", "qwen2_prefill_gqa7",
               "gemma2_prefill_window_softcap", "nemotron_prefill_d192",
               "whisper_cross_s1")

# decode attention: (name, b, h, kv, d, t, lengths, window, cap, dtype).
# The first case is the serving path's shape (8 slots of a 1024-position
# cache, a few hundred positions a row) and is timed. Lengths hold 0,
# T - 1 and lengths past T (free rows that ran past the cache's end);
# every row sees at least one position.
_PATH_LENGTHS = tuple(int(x) for x in
                      np.random.default_rng(0).integers(64, 577, 8))
_R_LENGTHS = tuple(int(x) for x in
                   np.random.default_rng(1).integers(64, 273, 8))
DECODE_CASES = [
    ("main_path", 8, 28, 4, 128, 1024, _PATH_LENGTHS, None, None,
     torch.bfloat16),
    ("qwen2_T2048_ragged", 8, 28, 4, 128, 2048,
     (0, 2047, 2048, 5000, 1, 63, 64, 700), None, None, torch.bfloat16),
    ("window", 4, 28, 4, 128, 1024, (100, 500, 1023, 900), 128, None,
     torch.bfloat16),
    ("softcap", 4, 28, 4, 128, 1024, (100, 500, 1023, 1500), None, 30.0,
     torch.bfloat16),
    ("mha_d64", 4, 12, 12, 64, 512, (0, 511, 300, 17), None, None,
     torch.bfloat16),
    ("fp32", 3, 8, 2, 32, 300, (10, 299, 150), 64, 20.0, torch.float32),
    ("b1", 1, 28, 4, 128, 1024, (700,), None, None, torch.bfloat16),
    ("tiny_T40", 2, 4, 2, 16, 40, (17, 39), None, None, torch.bfloat16),
    # phase (n)'s decode round: four slots of a 72-position cache (64-token
    # prompts, 8 new tokens), a ragged last tile
    ("dag_round", 4, 28, 4, 128, 72, (64, 66, 69, 71), None, None,
     torch.bfloat16),
    # phase (q): gemma2-27b's local layers in a decode round (4 slots of a
    # 5 120-position cache, window 4096, softcap 50, GQA 2: rows inside
    # and past the window) and nemotron-4-340b's head_dim 192 (GQA 12)
    ("gemma2_window_softcap", 4, 32, 16, 128, 5120, (4700, 4096, 5119, 300),
     4096, 50.0, torch.bfloat16),
    ("nemotron_d192", 4, 96, 8, 192, 1024, _PATH_LENGTHS[:4], None, None,
     torch.bfloat16),
    # phase (r)'s rounds on the 512-position cache (64-256-token prompts,
    # 16 new): 8 rows at 14/2 and 7/1 local heads ("model" of 2 and 4),
    # one data shard's 4 rows at 28/4 and 14/2 ((2, 1), (2, 2)), and
    # qwen2-moe's 16 heads split over 2 and its 4 rows of a data shard
    ("tp_14_2", 8, 14, 2, 128, 512, _R_LENGTHS, None, None, torch.bfloat16),
    ("tp_7_1", 8, 7, 1, 128, 512, _R_LENGTHS, None, None, torch.bfloat16),
    ("dp_rows4", 4, 28, 4, 128, 512, _R_LENGTHS[:4], None, None,
     torch.bfloat16),
    ("dp_rows4_tp_14_2", 4, 14, 2, 128, 512, _R_LENGTHS[4:], None, None,
     torch.bfloat16),
    ("tp_moe_8_8", 8, 8, 8, 128, 512, _R_LENGTHS, None, None,
     torch.bfloat16),
    ("dp_rows4_moe", 4, 16, 16, 128, 512, _R_LENGTHS[:4], None, None,
     torch.bfloat16),
    # phase (t): whisper-base's decoder self-attention at 4 heads a rank
    # on one data shard's 2 rows (D 64, a 64-position cache: prompts of
    # 4-16 tokens, 16 new), and a qwen2-7b replica on a (1, 2) slice: 4
    # slots at 14/2 heads
    ("t_whisper_dec_4_4", 2, 4, 4, 64, 64, (4, 31), None, None,
     torch.bfloat16),
    ("t_slice_14_2", 4, 14, 2, 128, 512, _R_LENGTHS[:4], None, None,
     torch.bfloat16),
    # phase (u): the front door's rounds on (2, 2) "tp", one data shard's 2
    # rows of a 4-slot replica at 14/2 heads (a 280-position cache: 256 +
    # 16 + 8), and (2, 2, 1)'s 2 rows a rank over pod x data at 28/4
    ("u_front_door_rows2_14_2", 2, 14, 2, 128, 280, _R_LENGTHS[:2], None,
     None, torch.bfloat16),
    ("u_pod_data_rows2", 2, 28, 4, 128, 512, _R_LENGTHS[2:4], None, None,
     torch.bfloat16),
]
# decode cases timed beside the serving path's shape (the first case)
TIMED_DECODE = ("gemma2_window_softcap", "nemotron_d192")

# fused sampling: (name, B, V, settings, n_split (None: the wrapper's
# pick), input pattern). The first case is the sampled serving run's
# setting at its shape (8 slots, qwen2's vocabulary) and fills the kernels
# line; every case is timed. Patterns: "randn" (N(0, 9) logits), "ties"
# (5 tokens above, then 60 tied at the 50th value), "ties_across_slices"
# (about 100 tied at the 50th value on both sides of every 5-, 7-, 8- and
# 16-way slice boundary), "argmax_tie" (y ties exactly in two slices: zero
# noise), "zeros" (-0.0 and +0.0 in several slices are the k-th value).
VOCAB = 152064
PATH_SAMPLING = serve_cluster.SAMPLING  # temperature 0.8, top-k 50, top-p 0.95
SAMPLE_CASES = [
    ("path", 8, VOCAB, PATH_SAMPLING, None, "randn"),
    ("temperature", 8, VOCAB, dict(temperature=0.8), None, "randn"),
    ("top_k", 8, VOCAB, dict(temperature=0.8, top_k=50), None, "randn"),
    ("top_p", 8, VOCAB, dict(temperature=0.8, top_p=0.9), None, "randn"),
    ("top_k_ties", 8, VOCAB, dict(temperature=1.0, top_k=50), None, "ties"),
    ("top_p_zero", 8, VOCAB, dict(temperature=1.0, top_p=0.0), None,
     "randn"),
    ("top_p_negative", 8, VOCAB, dict(temperature=1.0, top_p=-0.5), None,
     "randn"),
    ("path_n7", 8, VOCAB, PATH_SAMPLING, 7, "randn"),  # V % 7 != 0
    ("path_n5", 8, VOCAB, PATH_SAMPLING, 5, "randn"),  # the logits staged
    ("path_n1", 8, VOCAB, PATH_SAMPLING, 1, "randn"),  # a block a row
    ("admission_b1", 1, VOCAB, PATH_SAMPLING, None, "randn"),
    ("vocab_30522", 8, 30522, PATH_SAMPLING, None, "randn"),
    ("vocab_256000", 8, 256000, PATH_SAMPLING, None, "randn"),
    # phase (q)'s gemma2-27b sampled round: 4 slots of a 256 000 vocabulary,
    # which stages only the logits
    ("gemma2_round_b4_v256000", 4, 256000, PATH_SAMPLING, None, "randn"),
    # phase (r)'s sampled rounds on one data shard's 4 rows
    ("dp_rows4", 4, VOCAB, PATH_SAMPLING, None, "randn"),
    # phase (t)'s sampled whisper-base rounds: the logits a "model"-split
    # LM head gathers whole (V 51 865), one data shard's 2 rows and an
    # admission's 1
    ("t_whisper_b2_v51865", 2, 51865, PATH_SAMPLING, None, "randn"),
    ("t_whisper_b1_v51865", 1, 51865, PATH_SAMPLING, None, "randn"),
    # phase (u1)'s sampled front door: one data shard's 2 rows a round
    ("u_front_door_b2", 2, VOCAB, PATH_SAMPLING, None, "randn"),
    ("device_memory", 2, 1_000_000, PATH_SAMPLING, None, "randn"),
    ("top_k_1", 8, VOCAB, dict(temperature=0.8, top_k=1), None, "randn"),
    ("top_k_v", 2, VOCAB, dict(temperature=0.8, top_k=VOCAB), None,
     "randn"),
    # the k-th value deep in the row
    ("top_k_quarter", 2, VOCAB, dict(temperature=0.8, top_k=VOCAB // 4),
     None, "randn"),
    ("ties_across_slices", 4, VOCAB, dict(temperature=1.0, top_k=50), None,
     "ties_across_slices"),
    ("argmax_tie_across_slices", 4, VOCAB, dict(temperature=0.9, top_k=3),
     None, "argmax_tie"),
    ("signed_zeros", 4, VOCAB, dict(temperature=0.8, top_k=4), None,
     "zeros"),
]
# A top-p flip (kernel and plain version keep different tokens) is allowed
# only at a near-tie: the token's probability within this relative
# distance of the cutoff (twice the kernel's top-p margin).
TOP_P_NEAR_TIE = 2.0 / 16384


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, on CUDA
    events: the device's time, or the host's where it issues the calls
    more slowly than the device runs them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_flops(q, k, causal, window) -> float:
    """The two products' FLOPs over the visible (row, column) pairs."""
    b, s, h, d = q.shape
    t = k.shape[1]
    rows = torch.arange(s)[:, None]
    cols = torch.arange(t)[None, :]
    visible = torch.ones(s, t, dtype=torch.bool)
    if causal:
        visible &= cols <= rows
    if window is not None:
        visible &= cols > rows - window
    return 4.0 * b * h * d * int(visible.sum())


def attention_bound_ms(q, k, v, causal, window) -> tuple:
    """(least ms, "bytes" or "operations") for one attention call: q, k, v
    read once and o written once; two products over the visible (row,
    column) pairs of these inputs."""
    flops = attention_flops(q, k, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sharp_faults(window, cap) -> dict:
    """The planted faults of a sharp case: (window, softcap) the kernel
    is called with in place of the right ones."""
    faults = {"softcap off": (window, None)}
    if window is not None:
        faults.update({"window off": (None, cap),
                       "window -64": (window - 64, cap),
                       "window +64": (window + 64, cap)})
    return faults


def hold_sharp(name, call, want, rows, window, cap) -> dict:
    """A sharp case (SHARP_CASES): ``call(window, softcap)`` runs the
    kernel, ``want`` is the plain version's output, ``rows`` indexes the
    rows a window 64 positions off cuts. The kernel must agree within
    SHARP_RTOL on all rows and on those; every planted fault must not.
    Returns the errors, each (all rows, the window's rows)."""
    def errs(out):
        return (rel_rms(out.float(), want.float()),
                rel_rms(out[rows].float(), want[rows].float()))
    got = errs(call(window, cap))
    faults = {f: errs(call(*wc)) for f, wc in sharp_faults(window,
                                                           cap).items()}
    torch.cuda.synchronize()
    print(f"kernel {name} (q x {SHARP_Q:g}): relative RMS {got[0]:.3g}, "
          f"{got[1]:.3g} on the rows the window cuts (tol {SHARP_RTOL}); "
          f"planted faults " + ", ".join(
              f"{f} {e[0]:.3g}/{e[1]:.3g}" for f, e in faults.items()))
    if not all(math.isfinite(e) for e in got) or max(got) > SHARP_RTOL:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             f"version: {got}")
    blind = [f for f, e in faults.items() if not max(e) > SHARP_RTOL]
    if blind:
        raise AssertionError(f"{name}: the check passes the planted "
                             f"faults {blind}: {faults}")
    return {"rel_rms": got, "faults": faults}


def check_kernel(dev) -> dict:
    """Phase (a): the kernel against its plain version, case by case, and
    timed at the main path's shape and at qwen2-7b's prefill."""
    errs, inputs = [], {}
    for name, b, s, t, h, kv, d, causal, window, cap, dtype in CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                   for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
        if name in SHARP_CASES:
            q = q * SHARP_Q
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        err = (out.float() - ref.float()).abs().max().item()
        if name in SHARP_CASES:
            hold_sharp(name, lambda w, c: fa_ops.flash_attention(
                q, k, v, causal=causal, window=w, softcap=c), ref,
                (slice(None), slice(window - 64, None)), window, cap)
        tol = math.inf if name in SHARP_CASES else TOL[dtype]
        ok = out.shape == q.shape and math.isfinite(err) and err <= tol
        print(f"kernel {name}: q{tuple(q.shape)} k{tuple(k.shape)} "
              f"{str(dtype).removeprefix('torch.')} max_abs_err={err:.3g} "
              f"tol={tol:g} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with its "
                                 f"plain version on {name}: {err}")
        errs.append(err)
        if name in TIMED_FLASH:
            inputs[name] = (q, k, v, causal, window, cap)

    err = max(errs)
    timed = {}
    for name in TIMED_FLASH:
        q, k, v, causal, window, cap = inputs[name]
        kv = k.shape[2]
        if window is not None and cap is None:
            raise ValueError(f"{name}: sdpa takes no window")
        ms = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=cap), iters=50)
        kern_ms = kernel_device_ms(lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=cap), "flash_fwd")
        plain_ms = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=cap), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
        # no PyTorch call takes a softcap: there sdpa computes another
        # function, and no library time is kept
        library_ms = None if cap is not None else cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kv != q.shape[2]),
            iters=50)
        bound_ms, bound_by = attention_bound_ms(q, k, v, causal, window)
        flops = attention_flops(q, k, causal, window)
        timed[name] = {"shape": [list(q.shape), list(k.shape)],
                       "causal": causal, "ms": ms, "kernel_device_ms":
                       kern_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "tflops": flops / ms / 1e9}
        print(f"kernel flash_attention {name} q{tuple(q.shape)} "
              f"k{tuple(k.shape)} {'causal' if causal else 'bidir'}: "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s; the kernel "
              f"alone {kern_ms:.4f} ms, profiled), plain {plain_ms:.4f} ms, "
              f"sdpa {'n/a' if library_ms is None else f'{library_ms:.4f}'}"
              f" ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); those FLOPs on the fp32 FMA peak (a bf16 time "
              f"below it shows the tensor cores ran) "
              f"{1e3 * flops / PEAK_FLOPS[torch.float32]:.3f} ms")
    main = timed[TIMED_FLASH[0]]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:87",
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed": timed}


class _OutputDevices(torch.overrides.TorchFunctionMode):
    """Records the device of every tensor a torch function returns."""

    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor):
                self.devices.add(x.device.type)
        return out


def attention_layer_errors(cfg, params, batch) -> list:
    """Per layer: relative RMS error between the attention sublayer through
    the kernel and through the plain path, both fed the plain path's hidden
    state at that layer."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x = transformer._embed_in(cfg, params, tokens, None, positions)
    plain = RunConfig(attn_impl="xla")
    errs = []
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        h = apply_norm(cfg, p["norm1"], x)
        ys = [attention.attn_forward(cfg, p["attn"], h, mixer=spec.mixer,
                                     positions=positions, impl=impl,
                                     mask_kind="bidir").float()
              for impl in ("pallas", "xla")]
        errs.append(float(torch.linalg.vector_norm(ys[0] - ys[1])
                          / torch.linalg.vector_norm(ys[1])))
        x = transformer._apply_block_position(cfg, plain, spec, p, x,
                                              positions)[0]
    return errs


@contextlib.contextmanager
def attention_in_float64():
    """The plain attention path computing in float64: a more exact version
    of the same function, used to measure how far fp32 arithmetic moves
    this model's logits."""
    plain = attention._attend_dense

    def dense64(q, k, v, *, mask_kind, window, cap, q_offset=0):
        if (mask_kind, window, cap, q.shape[2]) != ("bidir", None, None,
                                                    k.shape[2]):
            raise ValueError("float64 reference covers bidirectional MHA")
        s = torch.einsum("bshd,bthd->bhst", q.double(), k.double())
        p = torch.softmax(s / q.shape[-1] ** 0.5, dim=-1)
        return torch.einsum("bhst,bthd->bshd", p, v.double()).to(q.dtype)

    attention._attend_dense = dense64
    try:
        yield
    finally:
        attention._attend_dense = plain


def run_main_path(dev) -> int:
    """Phase (b): the offline job at full width through ``run_offline``,
    with the kernel's launch count read around it; returns that count."""
    cfg = configs.get("distilbert-imdb")
    fa_ops.launches = 0
    out = run_offline(cfg, device=dev, run=RunConfig(attn_impl="pallas"),
                      **MAIN)
    launches = fa_ops.launches
    n_classify = sum(w.invocations for w in out["workers"])
    mono, par = out["mono_report"], out["par_report"]
    preds, mono_preds = out["predictions"], out["mono_predictions"]

    if launches != cfg.n_layers * n_classify:
        raise AssertionError(f"{launches} kernel launches for {n_classify} "
                             f"classify calls of {cfg.n_layers} layers")
    if not np.array_equal(preds, mono_preds):
        raise AssertionError("merged parallel predictions differ from the "
                             "monolithic ones")
    trees = [out["params"]] + [w.params for w in out["workers"]]
    off = [p for tree in trees for p, t in tree_leaves_with_path(tree)
           if t.device.type != dev.type]
    if off:
        raise AssertionError(f"parameters off the card: {off[:5]}")

    engine = out["engine"]
    tokens, _ = imdb_reviews(n=MAIN["n_items"], seq_len=MAIN["seq_len"],
                             vocab=cfg.vocab_size, seed=MAIN["seed"])
    bs = MAIN["batch_size"]
    batch = {"tokens": torch.as_tensor(tokens[:bs]).to(dev, torch.long)}
    spy = _OutputDevices()
    with torch.inference_mode(), spy:
        engine.model.forward(engine.run, out["params"], batch)
    if spy.devices != {dev.type}:
        raise AssertionError(f"activations on {sorted(spy.devices)}")

    # the same params and tokens through the plain attention on the card
    plain = Engine(engine.model, RunConfig(attn_impl="xla"), device=dev)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: engine.model.forward(
            engine.run, out["params"], batch), iters=10)
        forward_plain_ms = cuda_ms(lambda: plain.model.forward(
            plain.run, out["params"], batch), iters=10)
        attn_ms = kernel_device_ms(lambda: engine.model.forward(
            engine.run, out["params"], batch), "flash_fwd", n=10)
        layer_err = attention_layer_errors(cfg, out["params"], batch)
    print(f"forward of {bs} x {MAIN['seq_len']} tokens: {forward_ms:.4f} ms "
          f"(plain attention {forward_plain_ms:.4f} ms); the flash kernel "
          f"{attn_ms:.4f} ms of it in {cfg.n_layers} launches, share "
          f"{attn_ms / forward_ms:.3f}")
    print(f"per-layer attention, kernel vs plain on the same input: "
          f"relative RMS error {[f'{e:.3g}' for e in layer_err]} "
          f"(tol {LAYER_RTOL})")
    if max(layer_err) > LAYER_RTOL:
        raise AssertionError(f"attention sublayer disagrees: {layer_err}")

    def logits(eng):
        return np.concatenate([
            eng.classify_logits(out["params"], tokens[i:i + bs])
            for i in range(0, len(tokens), bs)])

    kern_logits, plain_logits = logits(engine), logits(plain)
    with attention_in_float64():
        ref_logits = logits(plain)
    if kern_logits.shape != (MAIN["n_items"], cfg.num_labels) or not \
            np.isfinite(kern_logits).all():
        raise AssertionError(f"bad logits: shape {kern_logits.shape}")
    noise = float(np.abs(plain_logits - ref_logits).max())
    bound = NOISE_FACTOR * noise + LOGIT_FLOOR
    logit_err = float(np.abs(kern_logits - ref_logits).max())
    gap = np.abs(ref_logits[:, 0] - ref_logits[:, 1])
    ref_labels = ref_logits.argmax(-1)
    flips = np.flatnonzero(preds != ref_labels)
    plain_flips = int((plain_logits.argmax(-1) != ref_labels).sum())
    hard_flips = [int(i) for i in flips if gap[i] >= bound]
    print(f"vs float64-attention reference: plain fp32 path max |logit "
          f"diff| {noise:.4g} and {plain_flips} label flips; kernel path "
          f"{logit_err:.4g} (bound {bound:.4g}) and {len(flips)} flips, "
          f"{len(hard_flips)} of them at a gap >= the bound")
    if logit_err > bound or hard_flips:
        raise AssertionError(f"kernel path vs float64 reference: logit diff "
                             f"{logit_err} > {bound} or flips past near-ties "
                             f"{hard_flips}")

    result = {
        "arch": cfg.name, **MAIN, "layers": cfg.n_layers,
        "classify_calls": n_classify, "kernel_launches": launches,
        "compile_count": engine.compile_count,
        "mono_wall_s": mono.wall_time_s, "par_wall_s": par.wall_time_s,
        "speedup": mono.wall_time_s / par.wall_time_s,
        "cost_ratio": par.cost_usd / mono.cost_usd,
        "mono_items_per_s": MAIN["n_items"] / mono.wall_time_s,
        "par_items_per_s": MAIN["n_items"] / par.wall_time_s,
        "mono_host_s": out["host_s"]["mono"],
        "par_host_s": out["host_s"]["par"],
        "par_compute_s": sum(t.outcome.compute_s for t in par.tasks),
        "forward_ms_per_batch": forward_ms,
        "forward_plain_attention_ms_per_batch": forward_plain_ms,
        "attention_kernel_ms_per_batch": attn_ms,
        "attention_share_of_forward": attn_ms / forward_ms,
        "accuracy": out["accuracy"],
        "attention_layer_rel_err": layer_err,
        "plain_logit_err_vs_fp64": noise, "plain_label_flips_vs_fp64":
        plain_flips, "kernel_logit_err_vs_fp64": logit_err,
        "kernel_label_flips_vs_fp64": len(flips),
    }
    print("offline " + json.dumps(result))
    return launches



# ---------------------------------------------------------------------------
# Phase (a2): decode attention and the sampling epilogue vs plain versions
# ---------------------------------------------------------------------------


def decode_bound_ms(q, k, lengths, n_pos, window=None, page_size=None,
                    scaled=False) -> tuple:
    """(least ms, "bytes" or "operations") of one decode-attention call on
    these inputs: q, lengths and o once; per visible position its K and V
    rows (``scaled``: and their two fp32 scales); paged (``page_size``):
    the table entries of the pages it touches. ``n_pos`` is a row's
    capacity (T, or Pmax * page_size). Two products over the visible
    positions."""
    b, h, d = q.shape
    kv = k.shape[2]
    lens = lengths.long().cpu()
    hi = torch.clamp(lens, max=n_pos - 1)
    lo = torch.zeros_like(lens) if window is None else torch.clamp(
        lens - window + 1, min=0)
    visible = int(torch.clamp(hi - lo + 1, min=0).sum())
    per_pos = 2 * kv * d * k.element_size() + (2 * kv * 4 if scaled else 0)
    nbytes = 2 * q.numel() * q.element_size() + 4 * b + visible * per_pos
    if page_size is not None:
        nbytes += 4 * sum(hi_ // page_size - lo_ // page_size + 1
                          for hi_, lo_ in zip(hi.tolist(), lo.tolist())
                          if hi_ >= lo_)
    flops = 4.0 * visible * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profile_round(fn, n_prof: int = 3,
                  names=("decode_kernel", "flash_fwd")) -> dict:
    """Where one call of ``fn`` (a decode round) spends device time:
    kernel events only (an op's own device time repeats its kernels'),
    averaged over ``n_prof`` calls under the profiler; ``by_name`` sums
    the ms of the kernels whose name holds each of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"busy_ms": device_us / n_prof / 1e3,
            "launches": sum(e.count for e in kernels) / n_prof,
            "window_ms": window_us / n_prof / 1e3,
            "breakdown": {e.key[:60]: round(e.self_device_time_total
                                            / n_prof, 1) for e in top},
            "by_name": {name: sum(e.self_device_time_total for e in kernels
                                  if name in e.key) / n_prof / 1e3
                        for name in names}}


def l2_flush_buffer(dev) -> torch.Tensor:
    """A buffer five times the H100's 50 MB L2 cache: writing it evicts
    whatever a kernel read before."""
    return torch.empty(256 << 20, dtype=torch.uint8, device=dev)


def profile_ops(fn, n: int = 5) -> dict:
    """Device time per call of ``fn``, each kernel counted once: in all
    (busy_ms); by the aten op that launched it (``ops_ms``, the op's own
    kernels, not its children's); by kernel name (``kernels_ms``, the
    hand-written kernels included: ctypes launches have no op)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    return {"busy_ms": sum(e.self_device_time_total for e in kernels)
            / n / 1e3,
            "ops_ms": {e.key: e.self_device_time_total / n / 1e3
                       for e in events if e.device_type == DeviceType.CPU
                       and e.self_device_time_total > 0},
            "kernels_ms": {e.key[:90]: e.self_device_time_total / n / 1e3
                           for e in kernels}}


def kernel_device_ms(fn, name: str, n: int = 20, flush=None) -> float:
    """Mean device time per call of ``fn`` spent in kernels whose name
    holds ``name``, from the profiler (after two warm-up calls). With
    ``flush`` (:func:`l2_flush_buffer`), the buffer is written before each
    call, so the call reads its inputs from device memory (cold L2)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / n / 1e3


def time_decode_case(q, k, v, lens, window, cap) -> dict:
    """One decode case's times: through the wrapper (CUDA events), the
    kernel alone (profiled), the plain version, sdpa where it computes the
    same function (no softcap), and the bound."""
    kw = dict(window=window, softcap=cap)
    ms = cuda_ms(lambda: da_ops.decode_attention(q, k, v, lens, **kw),
                 iters=50)
    kern_ms = kernel_device_ms(
        lambda: da_ops.decode_attention(q, k, v, lens, **kw), "decode_kernel")
    plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, lens, **kw),
                       iters=20)
    t = k.shape[1]
    pos = torch.arange(t, device=q.device)[None, :]
    seen = pos <= torch.clamp(lens[:, None], max=t - 1)
    if window is not None:
        seen &= pos > lens[:, None] - window
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    library_ms = None if cap is not None else cuda_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=seen[:, None, None, :], enable_gqa=True),
        iters=50)
    bound_ms, bound_by = decode_bound_ms(q, k, lens, t, window)
    n_split = da_ops._n_split(q, q.shape[0] * k.shape[2], t, window)
    print(f"kernel decode_attention q{tuple(q.shape)} k{tuple(k.shape)} "
          f"window {window} softcap {cap}: {ms:.4f} ms (n_split={n_split}; "
          f"the kernel alone {kern_ms:.4f} ms, profiled), plain "
          f"{plain_ms:.4f} ms, sdpa "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f}'} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"shape": [list(q.shape), list(k.shape)], "ms": ms,
            "kernel_device_ms": kern_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "n_split": n_split}


def check_decode_kernel(dev) -> dict:
    """Phase (a2), decode attention: kernel vs plain version case by case,
    timed at the serving path's shape and at phase (q)'s."""
    main, timed = None, {}
    for name, b, h, kv, d, t, lengths, window, cap, dtype in DECODE_CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        q = torch.randn(b, h, d, generator=g, device=dev, dtype=dtype)
        k, v = (torch.randn(b, t, kv, d, generator=g, device=dev,
                            dtype=dtype) for _ in range(2))
        if name in SHARP_CASES:
            q = q * SHARP_Q
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = da_ops.decode_attention(q, k, v, lens, window=window,
                                      softcap=cap)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens, window=window, softcap=cap)
        err = (out.float() - ref.float()).abs().max().item()
        if name in SHARP_CASES:
            hold_sharp(name, lambda w, c: da_ops.decode_attention(
                q, k, v, lens, window=w, softcap=c), ref,
                lens >= window - 64, window, cap)
        tol = math.inf if name in SHARP_CASES else TOL[dtype]
        ok = out.shape == q.shape and math.isfinite(err) and err <= tol
        print(f"kernel decode_attention {name}: q{tuple(q.shape)} "
              f"k{tuple(k.shape)} lengths {list(lengths)} "
              f"{str(dtype).removeprefix('torch.')} max_abs_err={err:.3g} "
              f"tol={tol:g} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"decode_attention kernel disagrees with "
                                 f"its plain version on {name}: {err}")
        if main is None:
            main = (q, k, v, lens, window, cap, err)
        if name in TIMED_DECODE:
            timed[name] = (q, k, v, lens, window, cap)
    timed = {name: time_decode_case(*x) for name, x in timed.items()}

    q, k, v, lens, window, cap, err = main
    ms = cuda_ms(lambda: da_ops.decode_attention(q, k, v, lens), iters=50)
    plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, lens), iters=20)
    t = k.shape[1]
    mask = (torch.arange(t, device=dev)[None, :]
            <= lens[:, None])[:, None, None, :]          # (B, 1, 1, T)
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=50)
    bound_ms, bound_by = decode_bound_ms(q, k, lens, k.shape[1], window)
    n_split = da_ops._n_split(q, q.shape[0] * k.shape[2], t, window)
    kern_ms = kernel_device_ms(lambda: da_ops.decode_attention(q, k, v, lens),
                               "decode_kernel")
    print(f"kernel decode_attention at the serving path's shape "
          f"q{tuple(q.shape)} k{tuple(k.shape)}: {ms:.4f} ms on a cluster "
          f"of n_split={n_split} blocks a (row, kv head) (the kernel alone "
          f"{kern_ms:.4f} ms, profiled), plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    if n_split < 2:
        raise AssertionError(f"the serving shape ran n_split={n_split}")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:202",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "n_split": n_split,
            "kernel_device_ms": kern_ms, "timed": timed}


def sampling_inputs(logits, kw, g):
    """The epilogue's inputs as ``fused_sample`` makes them: the top-p
    cutoff after the top-k mask, and Gumbel noise."""
    top_k, top_p = kw.get("top_k"), kw.get("top_p")
    use_top_p = top_p is not None and top_p < 1.0
    if use_top_p:
        z = fs.apply_filters(logits, temperature=kw["temperature"],
                             top_k=top_k)
        cutoff = fs.nucleus_cutoff(z, top_p)
    else:
        cutoff = torch.zeros(logits.shape[0], 1, device=logits.device)
    noise = fs.gumbel_noise(logits.shape, g, logits.device)
    return dict(logits=logits, gumbel=noise, cutoff=cutoff,
                temperature=kw["temperature"], top_k=top_k,
                use_top_p=use_top_p)


def sampling_flips(inputs, got, want) -> list:
    """Rows where the kernel's token differs from the plain version's:
    [(row, |p - cutoff| / cutoff of each of the two tokens)]. p is the
    token's probability after the top-k mask (the plain version's)."""
    rows = torch.nonzero(got != want).flatten().tolist()
    if not rows:
        return []
    z = fs.apply_filters(inputs["logits"], temperature=inputs["temperature"],
                         top_k=inputs["top_k"])
    p = torch.softmax(z, dim=-1)
    out = []
    for r in rows:
        c = float(inputs["cutoff"][r, 0])
        out.append((r, [abs(float(p[r, int(x[r])]) - c) / max(c, 1e-30)
                        for x in (got, want)]))
    return out


def check_flips(name, kw, flips):
    """Zero flips where there is no top-p; with top-p, only near-ties."""
    uses_p = kw.get("top_p") is not None and kw["top_p"] < 1.0
    bad = [f for f in flips
           if not uses_p or min(f[1]) > TOP_P_NEAR_TIE]
    if bad:
        raise AssertionError(f"fused_sample kernel disagrees with its plain "
                             f"version on {name} beyond top-p near-ties: "
                             f"{bad}")


def sample_case_inputs(pattern, b, v, kw, g, dev):
    """The epilogue's inputs for a SAMPLE_CASES pattern, and the tokens a
    row may take (None: any)."""
    logits = torch.randn(b, v, generator=g, device=dev) * 3
    allowed = None
    if pattern == "ties":
        logits[:, :5] = 30.0
        logits[:, 100:160] = 25.0
        allowed = set(range(5)) | set(range(100, 160))
    elif pattern == "ties_across_slices":
        ties = sorted({i * -(-v // n) + d for n in (5, 7, 8, 16)
                       for i in range(1, n) for d in (-2, -1, 0, 1)})
        top = [11, v // 4 + 1, v // 2 + 7, 4 * v // 5 + 3, v - 3]
        logits -= 20
        logits[:, top] = 30.0
        logits[:, ties] = 25.0
        allowed = set(ties) | set(top)
    elif pattern == "argmax_tie":
        per = -(-v // 8)
        logits.zero_()
        logits[:, [per + 3, 6 * per + 1]] = 7.0
        allowed = {per + 3}
    elif pattern == "zeros":
        top = [17, v // 2 + 5, v - 7]
        zeros = [5, v // 16 + 1, v // 8 + 1, v // 2, v - 1]
        logits.fill_(-1.0)
        logits[:, top] = 2.0
        for i, x in zip(zeros, (-0.0, 0.0, -0.0, 0.0, -0.0)):
            logits[:, i] = x
        allowed = set(zeros) | set(top)
    inputs = sampling_inputs(logits, kw, g)
    if pattern == "argmax_tie":
        inputs["gumbel"].zero_()
    return inputs, allowed


def sample_kernel_ms(inputs, flush, n_split=None) -> tuple:
    """The sampling kernel alone on ``inputs`` (device ms a call under the
    profiler): warm (inputs left in L2) and cold (L2 flushed first)."""
    def call():
        return fs.fused_sample_kernel(**inputs, n_split=n_split)
    return (kernel_device_ms(call, "sample_kernel"),
            kernel_device_ms(call, "sample_kernel", flush=flush))


def keys_under_first_digit(inputs) -> tuple:
    """Per row of an epilogue call with top-k: how many keys of z share
    the k-th value's first radix digit (its sign and top 7 exponent
    bits), in the row and in the fullest of the kernel's slices. The top-k
    steps after the first count these keys."""
    z = inputs["logits"] / inputs["temperature"]
    kth = torch.topk(z, inputs["top_k"], dim=-1).values[:, -1:]

    def digit(x):
        u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = torch.where(u == 0x80000000, 0, u)
        key = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
        return key >> 24

    under = (digit(z) == digit(kth)).int()
    b, v = z.shape
    n = fs.choose_sample_split(b, v, fs._sm_count(z.device.index or 0))
    per = -(-v // n)
    padded = F.pad(under, (0, n * per - v))
    return (under.sum(-1).tolist(),
            padded.view(b, n, per).sum(-1).amax(-1).tolist())


def check_sampling_kernel(dev) -> dict:
    """Phase (a2), the sampling epilogue: case by case, tokens equal the
    plain version's except at top-p near-ties (none allowed without
    top-p), and the kernel alone timed under the profiler with its inputs
    in L2 (warm) and with L2 flushed before each call (cold); the serving
    path's case also on CUDA events through the wrapper."""
    flush = l2_flush_buffer(dev)
    sms = fs._sm_count(dev.index or 0)
    main = None
    for name, b, v, kw, n_split, pattern in SAMPLE_CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        used = n_split or fs.choose_sample_split(b, v, sms)
        flips, rows = [], 0
        for _ in range(4):
            inputs, allowed = sample_case_inputs(pattern, b, v, kw, g, dev)
            got = fs.fused_sample_kernel(**inputs, n_split=n_split)
            torch.cuda.synchronize()
            want = fs.fused_sample_ref(**inputs)
            flips += sampling_flips(inputs, got, want)
            rows += b
            if allowed is not None and not set(want.tolist()) <= allowed:
                raise AssertionError(f"{name}: the plain version drew "
                                     f"{want.tolist()}")
            if name.startswith("top_p_") and not flips:
                assert torch.equal(got, inputs["logits"].argmax(-1).int())
        check_flips(name, kw, flips)
        warm, cold = sample_kernel_ms(inputs, flush, n_split)
        print(f"kernel fused_sample {name} ({b}, {v}) {kw} n_split={used} "
              f"({fs.staging(v, used)} staged): {rows} rows, {len(flips)} "
              f"flips vs plain {[round(min(f[1]), 9) for f in flips]} "
              f"(|p - cutoff| / cutoff) ok; the kernel alone {warm:.4f} ms "
              f"warm, {cold:.4f} ms cold L2")
        if main is None:
            main = (inputs, len(flips), used, warm, cold)
    inputs, n_flips, n_split, warm, cold = main
    ms = cuda_ms(lambda: fs.fused_sample_kernel(**inputs), iters=20)
    plain_ms = cuda_ms(lambda: fs.fused_sample_ref(**inputs), iters=20)
    b, v = inputs["logits"].shape
    nbytes = 2 * b * v * 4 + 2 * b * 4
    ops = b * v * (2 + 1 + 3)  # divide, add noise; top-k test; exp/div/test
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                         ops / PEAK_FLOPS[torch.float32])
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / PEAK_FLOPS[torch.float32] else "operations")
    print(f"kernel fused_sample at the serving path's shape ({b}, {v}) "
          f"{PATH_SAMPLING}: {ms:.4f} ms on events through the wrapper, "
          f"the kernel alone {warm:.4f} ms warm / {cold:.4f} ms cold L2 "
          f"(n_split={n_split}), plain {plain_ms:.4f} ms, no single library "
          f"call, bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "fused_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "fused_sampling.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "fused_sampling.py:171",
            # a sampler's error is its tokens: flips vs the plain version
            "max_abs_err": float(n_flips), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "n_split": n_split, "kernel_device_ms": warm,
            "kernel_device_ms_cold": cold}


# ---------------------------------------------------------------------------
# Phase (a3): the int8, paged and paged-int8 decode-attention kernels
# ---------------------------------------------------------------------------

# (name, variant, b, h, kv, d, logical positions, page size, lengths,
#  window, cap, q dtype, options). Variants: "quant" (dense int8), "paged"
# (bf16/fp32 pools), "paged_quant" (int8 pools). The first case of each
# variant is the serving path's shape and is timed. Pools are permuted;
# options: "share" (rows 0 and 1 share their first pages), "free" (the last
# row is free: an all-zero table, length past its prompt), "zero" (every
# third token all zeros: scale eps), "spread" (random int8 values, scales
# 1e-3 .. 10).
A3_CASES = [
    ("quant_main_path", "quant", 8, 28, 4, 128, 1024, None, _PATH_LENGTHS,
     None, None, torch.bfloat16, ()),
    ("paged_main_path", "paged", 8, 28, 4, 128, 1024, 16, _PATH_LENGTHS,
     None, None, torch.bfloat16, ()),
    ("paged_quant_main_path", "paged_quant", 8, 28, 4, 128, 1024, 16,
     _PATH_LENGTHS, None, None, torch.bfloat16, ()),
]
for _v in ("quant", "paged", "paged_quant"):
    _ps = None if _v == "quant" else 16
    _pq = () if _v == "quant" else ("share", "free")
    A3_CASES += [
        (f"{_v}_edges", _v, 6, 28, 4, 128, 1024, _ps,
         (0, 1023, 1024, 5000, 1, 64), None, None, torch.bfloat16, _pq),
        (f"{_v}_window_softcap", _v, 4, 28, 4, 128, 1024, _ps,
         (100, 500, 1023, 900), 128, 30.0, torch.bfloat16, ()),
        (f"{_v}_mha_d64_fp32_b1", _v, 1, 12, 12, 64, 512, _ps, (300,),
         None, None, torch.float32, ()),
    ]
A3_CASES += [
    (f"paged_ps{ps}", "paged", 4, 28, 4, 128, 960, ps, (0, 959, 500, 77),
     None, None, torch.bfloat16, ("share", "free"))
    for ps in (8, 64, 24)      # 24 does not divide the 64-position tile
] + [
    (f"paged_quant_ps{ps}", "paged_quant", 4, 28, 4, 128, 960, ps,
     (0, 959, 500, 77), None, None, torch.bfloat16, ("share", "free"))
    for ps in (8, 64, 24)
] + [
    ("quant_zero_tokens", "quant", 3, 28, 4, 128, 256, None, (255, 100, 9),
     None, None, torch.bfloat16, ("zero",)),
    ("quant_scale_spread", "quant", 3, 28, 4, 128, 256, None,
     (255, 100, 9), None, None, torch.float32, ("spread",)),
    ("paged_quant_zero_tokens", "paged_quant", 3, 28, 4, 128, 256, 16,
     (255, 100, 9), None, None, torch.bfloat16, ("zero",)),
    ("paged_quant_scale_spread", "paged_quant", 3, 28, 4, 128, 256, 16,
     (255, 100, 9), None, None, torch.float32, ("spread",)),
]
A3_KERNELS = {
    "quant": ("decode_attention_quant", "decode_attention.py:257"),
    "paged": ("paged_decode_attention", "decode_attention.py:388"),
    "paged_quant": ("paged_decode_attention_quant", "decode_attention.py:457"),
}


def _int8_kv(shape, g, dev, options):
    """int8 values and fp32 (..., 1) scales: quantized normal data (every
    third token zeroed under "zero"), or random values with scales spread
    over 1e-3 .. 10 under "spread"."""
    if "spread" in options:
        vals = torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
        expo = torch.rand(shape[:-1] + (1,), generator=g, device=dev)
        return vals, 10.0 ** (4.0 * expo - 3.0)
    x = torch.randn(shape, generator=g, device=dev)
    if "zero" in options:
        x.view(-1, *shape[-2:])[::3] = 0.0
    return quantize_kv(x)


def a3_inputs(case, dev) -> dict:
    """The kernel's inputs for one case, from a generator seeded by name."""
    name, variant, b, h, kv, d, n_pos, ps, lengths, _, _, dtype, opts = case
    g = torch.Generator(device=dev).manual_seed(len(name) + 7)
    out = {"q": torch.randn(b, h, d, generator=g, device=dev, dtype=dtype),
           "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev)}
    if variant == "quant":
        shape = (b, n_pos, kv, d)
    else:
        pmax = n_pos // ps
        n_pages = 1 + b * pmax
        shape = (n_pages, ps, kv, d)
        perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
        table = perm[:b * pmax].reshape(b, pmax).to(torch.int32)
        if "share" in opts:  # rows 0 and 1 read the same first pages
            table[1, :pmax // 2] = table[0, :pmax // 2]
        if "free" in opts:   # a freed row: all-null table
            table[-1] = 0
        out["page_table"] = table.contiguous()
    if variant == "paged":
        out["k"], out["v"] = (torch.randn(shape, generator=g, device=dev,
                                          dtype=dtype) for _ in range(2))
    else:
        out["k"], out["k_scale"] = _int8_kv(shape, g, dev, opts)
        out["v"], out["v_scale"] = _int8_kv(shape, g, dev, opts)
    return out


def a3_call(variant, x, window=None, cap=None, plain=False):
    """The kernel (or, ``plain``, its plain version) of ``variant`` on the
    inputs ``x``."""
    kw = dict(window=window, softcap=cap)
    scales = (x["k_scale"], x["v_scale"]) if "k_scale" in x else ()
    if plain:
        fn = {"quant": decode_attention_quant_ref,
              "paged": paged_decode_attention_ref,
              "paged_quant": paged_decode_attention_quant_ref}[variant]
        table = () if variant == "quant" else (x["page_table"],)
        return fn(x["q"], x["k"], x["v"], *scales, x["lengths"], *table,
                  **kw)
    if scales:
        kw.update(k_scale=scales[0], v_scale=scales[1])
    if variant == "quant":
        return da_ops.decode_attention(x["q"], x["k"], x["v"], x["lengths"],
                                       **kw)
    return da_ops.paged_decode_attention(x["q"], x["k"], x["v"],
                                         x["lengths"], x["page_table"], **kw)


def check_variant_kernels(dev) -> list:
    """Phase (a3): each new kernel against its plain version case by case
    (max |error| within the tolerance of q's dtype times
    max(1, max |plain|), as the spread scales reach values near 1000),
    timed at the serving path's shape beside its bound, its plain version
    and the dense bf16 kernel at the same logical shape."""
    timed = {}
    for case in A3_CASES:
        name, variant, b, h, kv, d, n_pos, ps, lengths, window, cap, \
            dtype, opts = case
        x = a3_inputs(case, dev)
        out = a3_call(variant, x, window, cap)
        torch.cuda.synchronize()
        ref = a3_call(variant, x, window, cap, plain=True)
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dtype] * max(1.0, ref.float().abs().max().item())
        ok = (out.shape == x["q"].shape and out.dtype == dtype
              and math.isfinite(err) and err <= tol)
        print(f"kernel {A3_KERNELS[variant][0]} {name}: q{tuple(x['q'].shape)}"
              f" kv{tuple(x['k'].shape)} ps {ps} lengths {list(lengths)} "
              f"window {window} cap {cap} {list(opts)} "
              f"{str(dtype).removeprefix('torch.')} max_abs_err={err:.3g} "
              f"tol={tol:.3g} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{A3_KERNELS[variant][0]} kernel disagrees "
                                 f"with its plain version on {name}: {err}")
        if variant not in timed:
            timed[variant] = (case, x, err)

    results = []
    for variant, (case, x, err) in timed.items():
        name, _, b, h, kv, d, n_pos, ps = case[:8]
        ms = cuda_ms(lambda: a3_call(variant, x), iters=50)
        plain_ms = cuda_ms(lambda: a3_call(variant, x, plain=True),
                           iters=20)
        g = torch.Generator(device=dev).manual_seed(1)
        kd, vd = (torch.randn(b, n_pos, kv, d, generator=g, device=dev,
                              dtype=x["q"].dtype) for _ in range(2))
        dense_ms = cuda_ms(lambda: da_ops.decode_attention(
            x["q"], kd, vd, x["lengths"]), iters=50)
        bound_ms, bound_by = decode_bound_ms(
            x["q"], x["k"], x["lengths"], n_pos, page_size=ps,
            scaled="k_scale" in x)
        n_split = da_ops._n_split(x["q"], b * kv, n_pos, None)
        kern_ms = kernel_device_ms(lambda: a3_call(variant, x),
                                   "decode_kernel")
        kname, line = A3_KERNELS[variant]
        print(f"kernel {kname} at the serving path's shape "
              f"q{tuple(x['q'].shape)} kv{tuple(x['k'].shape)}: {ms:.4f} ms "
              f"on n_split={n_split} (the kernel alone {kern_ms:.4f} ms, "
              f"profiled), plain {plain_ms:.4f} ms, dense bf16 kernel at "
              f"the same logical shape {dense_ms:.4f} ms, no single library "
              f"call, bound {bound_ms:.5f} ms ({bound_by})")
        results.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "decode_attention.cu",
            "replaces": f"src/repro/kernels/decode_attention/{line}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "dense_kernel_ms": dense_ms, "n_split": n_split,
            "kernel_device_ms": kern_ms})
    return results


# ---------------------------------------------------------------------------
# Phase (a4): the partials decode-attention kernel (sequence shards)
# ---------------------------------------------------------------------------

# (name, b, h, kv, d, t, lengths, window, cap, q dtype). Each case's cache
# is cut into M = 1, 2 and 4 sequence shards; every shard's (num, den, m)
# is held against the plain version and the merged output against the
# dense decode kernel on the whole cache. The first case is the serving
# path's shape and is timed. "edges" holds 0, Sl - 1 and Sl of the 4-way
# cut (Sl = 256), T - 1 and lengths past T: at length 0 three of four
# shards, and at 255 two of four, hold no visible position (the neutral
# element); "window" crosses shard boundaries at M = 4.
A4_CASES = [
    ("main_path", 8, 28, 4, 128, 1024, _PATH_LENGTHS, None, None,
     torch.bfloat16),
    ("edges", 8, 28, 4, 128, 1024, (0, 255, 256, 511, 512, 1023, 1024, 3000),
     None, None, torch.bfloat16),
    ("window", 4, 28, 4, 128, 1024, (100, 300, 600, 1023), 128, None,
     torch.bfloat16),
    ("softcap", 4, 28, 4, 128, 1024, (100, 500, 1023, 1500), None, 30.0,
     torch.bfloat16),
    ("mha_d64", 4, 12, 12, 64, 512, (0, 511, 300, 17), None, None,
     torch.bfloat16),
    ("fp32", 3, 8, 2, 64, 512, (10, 511, 150), 64, 20.0, torch.float32),
    ("b1", 1, 28, 4, 128, 1024, (700,), None, None, torch.bfloat16),
]
A4_SHARDS = (1, 2, 4)
# kernel vs plain partials: both compute in fp32 from the same inputs, so
# they differ by the order of fp32 sums and exp's last bits only
PARTIALS_RTOL = 1e-4


def merge_partials(parts, q):
    """The ranks' merge of ``dist.collectives``, done locally: M = max m,
    sums of ``num e^{m-M}`` and ``den e^{m-M}``, then ``num / max(den,
    1e-30)`` in q's dtype."""
    m_g = torch.stack([m for _, _, m in parts]).amax(0)
    num = sum(n * torch.exp(m - m_g)[..., None] for n, _, m in parts)
    den = sum(dn * torch.exp(m - m_g) for _, dn, m in parts)
    return (num / torch.clamp(den, min=1e-30)[..., None]).reshape(
        q.shape).to(q.dtype)


def partials_bound_ms(q, k_blk, lengths, offset, window) -> tuple:
    """(least ms, "bytes" or "operations") of one partials call on a
    shard: q and the (B,) lengths read once, the shard's visible K/V rows,
    the fp32 num, den and m written once; two products over the visible
    positions."""
    b, h, d = q.shape
    sl, kv = k_blk.shape[1], k_blk.shape[2]
    local = lengths.long().cpu() - offset
    hi = torch.clamp(local, max=sl - 1)
    lo = (torch.zeros_like(local) if window is None
          else torch.clamp(local - window + 1, min=0))
    visible = int(torch.clamp(hi - lo + 1, min=0).sum())
    nbytes = (q.numel() * q.element_size() + 4 * b
              + visible * 2 * kv * d * k_blk.element_size()
              + 4 * (b * h * d + 2 * b * h))
    flops = 4.0 * visible * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _shard(t, m, r):
    sl = t.shape[1] // m
    return t[:, r * sl:(r + 1) * sl].contiguous(), r * sl


def check_partials_kernel(dev) -> dict:
    """Phase (a4): the partials kernel against its plain version on every
    shard of each case at M = 1, 2 and 4, the merged shards against the
    dense decode kernel on the whole cache, the neutral element exactly,
    and the timings at the serving path's shape."""
    worst = 0.0
    main = None
    for name, b, h, kv, d, t, lengths, window, cap, dtype in A4_CASES:
        g = torch.Generator(device=dev).manual_seed(len(name) + 11)
        q = torch.randn(b, h, d, generator=g, device=dev, dtype=dtype)
        k, v = (torch.randn(b, t, kv, d, generator=g, device=dev,
                            dtype=dtype) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        dense = da_ops.decode_attention(q, k, v, lens, window=window,
                                        softcap=cap)
        for m in A4_SHARDS:
            parts, err, neutral = [], 0.0, 0
            for r in range(m):
                (kb, off), (vb, _) = _shard(k, m, r), _shard(v, m, r)
                got = da_ops.decode_attention_partials(
                    q, kb, vb, lens, offset=off, window=window, softcap=cap)
                torch.cuda.synchronize()
                want = decode_attention_partials_ref(
                    q, kb, vb, lens, offset=off, window=window, softcap=cap)
                for x, y in zip(got, want):
                    e = (x - y).abs().max().item() / max(
                        1.0, y.abs().max().item())
                    err = max(err, e if math.isfinite(e) else math.inf)
                # rows this shard sees nothing of: exactly (0, 0, -1e30)
                local = lens.long() - off
                lo = (torch.zeros_like(local) if window is None
                      else torch.clamp(local - window + 1, min=0))
                empty = (torch.clamp(local, max=kb.shape[1] - 1) < lo)
                for row in torch.nonzero(empty).flatten().tolist():
                    neutral += 1
                    if got[0][row].abs().max() != 0 or \
                            got[1][row].abs().max() != 0 or \
                            (got[2][row] != -1e30).any():
                        raise AssertionError(f"partials {name} M={m} shard "
                                             f"{r} row {row}: not the "
                                             f"neutral element")
                parts.append(got)
            merged = merge_partials(parts, q)
            merr = (merged.float() - dense.float()).abs().max().item()
            ok = (err <= PARTIALS_RTOL and math.isfinite(merr)
                  and merr <= TOL[dtype])
            print(f"kernel decode_attention_partials {name} M={m}: "
                  f"q{tuple(q.shape)} k{tuple(k.shape)} lengths "
                  f"{list(lengths)} window {window} cap {cap} "
                  f"{str(dtype).removeprefix('torch.')}: shards vs plain "
                  f"max rel err {err:.3g} (tol {PARTIALS_RTOL:g}), "
                  f"{neutral} empty (row, shard) pairs neutral, merged vs "
                  f"dense kernel max_abs_err={merr:.3g} tol={TOL[dtype]:g} "
                  f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise AssertionError(f"decode_attention_partials disagrees "
                                     f"on {name} at M={m}: {err}, {merr}")
            worst = max(worst, err)
        if main is None:
            main = (q, k, v, lens)

    q, k, v, lens = main
    dense_ms = cuda_ms(lambda: da_ops.decode_attention(q, k, v, lens),
                       iters=50)
    timed = {}
    for m in A4_SHARDS:
        per = []
        for r in range(m):
            (kb, off), (vb, _) = _shard(k, m, r), _shard(v, m, r)
            ms = cuda_ms(lambda: da_ops.decode_attention_partials(
                q, kb, vb, lens, offset=off), iters=50)
            bound, by = partials_bound_ms(q, kb, lens, off, None)
            per.append({"ms": ms, "bound_ms": bound, "bound_by": by})
            if m == 1:
                plain_ms = cuda_ms(lambda: decode_attention_partials_ref(
                    q, kb, vb, lens, offset=off), iters=20)
        timed[m] = per
        n_split = da_ops._n_split(q, q.shape[0] * k.shape[2],
                                  k.shape[1] // m, None)
        print(f"kernel decode_attention_partials at the serving path's "
              f"shape cut into M={m} (n_split={n_split} a shard): per shard "
              f"{[round(x['ms'], 4) for x in per]} ms, bounds "
              f"{[round(x['bound_ms'], 5) for x in per]} ms "
              f"({per[0]['bound_by']}); dense decode kernel on the whole "
              f"cache {dense_ms:.4f} ms")
    one = timed[1][0]
    # the kernels' own device time (the events above include the
    # wrapper's output allocations and the host's launch)
    kern_ms = kernel_device_ms(lambda: da_ops.decode_attention_partials(
        q, k, v, lens), "decode_kernel")
    dense_kern_ms = kernel_device_ms(
        lambda: da_ops.decode_attention(q, k, v, lens), "decode_kernel")
    print(f"kernel decode_attention_partials at the serving path's shape "
          f"q{tuple(q.shape)} k{tuple(k.shape)}, one shard: "
          f"{one['ms']:.4f} ms, plain {plain_ms:.4f} ms, dense kernel "
          f"{dense_ms:.4f} ms, no single library call, bound "
          f"{one['bound_ms']:.5f} ms ({one['bound_by']}); profiled device "
          f"time of the kernel alone {kern_ms:.4f} ms, of the dense kernel "
          f"{dense_kern_ms:.4f} ms")
    return {"name": "decode_attention_partials", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:317",
            "max_abs_err": worst, "ms": one["ms"], "plain_ms": plain_ms,
            "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
            "library_ms": None, "dense_kernel_ms": dense_ms,
            "kernel_device_ms": kern_ms,
            "n_split": da_ops._n_split(q, q.shape[0] * k.shape[2],
                                       k.shape[1], None),
            "dense_kernel_device_ms": dense_kern_ms,
            "per_shard": {str(m): x for m, x in timed.items()}}


# ---------------------------------------------------------------------------
# Phase (c): generative serving at full width
# ---------------------------------------------------------------------------

# the example's card sizes, seed and run config (full-width qwen2-7b)
GEN = serve_cluster.CARD_SIZES
# the one-rank seq-shard path (g) and the entry point held to its streams
# (e): qwen2-7b's widths at SEQ_LAYERS of its 28 layers, cut from 28 to
# make room for phase (s) (the same seq-shard path runs at 28 layers on
# two ranks in (h) and on (2, 2) in phase (r))
SEQ_LAYERS = 8
SEED = serve_cluster.SEED


def reset_counts():
    fa_ops.launches = da_ops.launches = fs.launches = 0
    da_ops.quant_launches = da_ops.paged_launches = 0
    da_ops.paged_quant_launches = da_ops.partials_launches = 0


def read_counts() -> dict:
    return {"flash_attention": fa_ops.launches,
            "decode_attention": da_ops.launches,
            "decode_attention_quant": da_ops.quant_launches,
            "paged_decode_attention": da_ops.paged_launches,
            "paged_decode_attention_quant": da_ops.paged_quant_launches,
            "decode_attention_partials": da_ops.partials_launches,
            "fused_sample": fs.launches}


NO_LAUNCHES = dict.fromkeys(read_counts(), 0)


def clone_cache(cache: Cache) -> Cache:
    return Cache(layers=tuple({n: t.clone() for n, t in layer.items()}
                              for layer in cache.layers),
                 lengths=cache.lengths.clone(), seq_shards=cache.seq_shards)


@contextlib.contextmanager
def decode_attention_in_float64():
    """The plain decode attention computing in float64: a more exact
    version of the same function, used to measure how far fp32 arithmetic
    moves this model's logits."""
    plain = attention.decode_attention_ref

    def ref64(q, k_cache, v_cache, lengths, **kw):
        return plain(q.double(), k_cache.double(), v_cache.double(), lengths,
                     **kw).to(q.dtype)

    attention.decode_attention_ref = ref64
    try:
        yield
    finally:
        attention.decode_attention_ref = plain


def decode_layer_errors(cfg, params, cache, token, kernel_cfg=None,
                        rows=None) -> list:
    """Per layer: relative RMS error between the decode attention sublayer
    through the kernel and through the plain path, both fed the plain
    path's hidden state at that layer (the cache gets the same k/v from
    both), over the batch rows ``rows`` (default all). ``kernel_cfg``
    (default ``cfg``) is the config the kernel side runs: a planted
    fault."""
    kernel_cfg = kernel_cfg or cfg
    lengths = cache.lengths
    x = transformer._embed_in(cfg, params, token, None,
                              lengths[:, None].long())
    errs = []
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        h = apply_norm(cfg, p["norm1"], x)
        ys = [attention.attn_decode_layer(c_, p["attn"], h, c["k"], c["v"],
                                          lengths, mixer=spec.mixer,
                                          impl=impl)[0]
              for c_, impl in ((kernel_cfg, "pallas"), (cfg, "xla"))]
        got, want = (y.float() if rows is None else y[rows].float()
                     for y in ys)
        errs.append(float(torch.linalg.vector_norm(got - want)
                          / torch.linalg.vector_norm(want)))
        x = transformer._mlp_residual(
            cfg, RunConfig(), spec, p,
            transformer._mixer_residual(cfg, p, x, ys[1]))[0]
    return errs


class _SampleSpy:
    """Wraps ``fused_sample_kernel`` during a run: keeps each call's inputs
    and tokens on the card, so the run can be held against the plain
    epilogue afterwards (those comparisons launch nothing)."""

    def __init__(self):
        self.calls = []
        self.kernel = fs.fused_sample_kernel

    def __call__(self, logits, gumbel, cutoff, **kw):
        out = self.kernel(logits, gumbel, cutoff, **kw)
        self.calls.append((dict(logits=logits.clone(), gumbel=gumbel.clone(),
                                cutoff=cutoff.clone(), **kw), out.clone()))
        return out

    def __enter__(self):
        fs.fused_sample_kernel = self
        return self

    def __exit__(self, *exc):
        fs.fused_sample_kernel = self.kernel

    def flips(self) -> list:
        out = []
        for inputs, got in self.calls:
            want = fs.fused_sample_ref(**inputs)
            out += sampling_flips(inputs, got, want)
        return out


def serve_phase(engine, params, cfg, on_round=None, **kw) -> dict:
    reqs = serve_cluster.make_requests(cfg.vocab_size, GEN.n_requests,
                                       GEN.prompt_len, GEN.new_tokens, SEED)
    torch.cuda.synchronize()
    reset_counts()
    res = serve_cluster.serve(engine, params, reqs, n_slots=GEN.n_slots,
                              max_len=GEN.max_len, seed=SEED,
                              on_round=on_round, **kw)
    torch.cuda.synchronize()
    res["counts"] = read_counts()
    res["requests"] = reqs
    b = res["batcher"]
    rejected = b.take_rejected()
    admissions = len(reqs) - len(rejected)
    if rejected or len(res["completed"]) != len(reqs):
        raise AssertionError(f"{len(rejected)} rejected, "
                             f"{len(res['completed'])} completed")
    want = dict(NO_LAUNCHES,
                flash_attention=cfg.n_layers * admissions,
                decode_attention=cfg.n_layers * b.decode_dispatches,
                fused_sample=(admissions + b.decode_dispatches
                              if b.fused_sampling else 0))
    if res["counts"] != want:
        raise AssertionError(f"launches {res['counts']}, want {want}")
    if b.decode_dispatches != b.rounds:
        raise AssertionError(f"{b.decode_dispatches} decode calls in "
                             f"{b.rounds} rounds")
    if b.fused_sampling and b.sampler_dispatches:
        raise AssertionError(f"{b.sampler_dispatches} host-sampler steps "
                             f"with fused sampling")
    res["admissions"] = admissions
    return res


def run_generation(dev) -> tuple:
    """Phase (c): full-width qwen2-7b continuous batching, greedy, fused
    sampled and host sampled, with the checks of the serving contract, the
    kernel-vs-plain checks on the real model and the timings. Returns the
    launch counts and the greedy token streams."""
    cfg = configs.get("qwen2-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    off = [p for p, t in tree_leaves_with_path(params)
           if t.device.type != dev.type]
    if off:
        raise AssertionError(f"parameters off the card: {off[:5]}")
    param_gb = sum(t.numel() * t.element_size()
                   for _, t in tree_leaves_with_path(params)) / 1e9
    engine = Engine(model, serve_cluster.RUN, device=dev)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "param_gb": param_gb,
           "init_s": init_s, "n_requests": GEN.n_requests,
           "n_slots": GEN.n_slots, "prompt_len": GEN.prompt_len,
           "new_tokens": GEN.new_tokens, "max_len": GEN.max_len,
           "seed": SEED}

    # greedy, with the in-place and memory checks round by round
    rounds = []

    def on_round(b):
        rounds.append(([t.data_ptr() for t in b.cache.tensors()],
                       torch.cuda.memory_allocated(), b.engine.compile_count))

    torch.cuda.reset_peak_memory_stats()
    greedy = serve_phase(engine, params, cfg, on_round=on_round)
    b = greedy["batcher"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in b.cache.tensors())
    ptrs = {tuple(r[0]) for r in rounds}
    live = [r[1] for r in rounds]
    peak = torch.cuda.max_memory_allocated()
    n_shapes = len({len(r.prompt) for r in greedy["requests"]})
    if len(ptrs) != 1:
        raise AssertionError("the shared cache moved between rounds")
    if max(live) - min(live) > 1 << 20:
        raise AssertionError(f"memory in use drifts across rounds: "
                             f"{min(live)} .. {max(live)} bytes")
    if peak - live[-1] >= cache_bytes:
        raise AssertionError(f"peak {peak} exceeds the {live[-1]} bytes in "
                             f"use by a cache's worth ({cache_bytes})")
    if engine.compile_count != n_shapes + 2 or rounds[-1][2] != n_shapes + 2:
        raise AssertionError(f"{engine.compile_count} shape buckets for "
                             f"{n_shapes} prompt lengths (+ decode, free)")
    print(f"generate greedy: {b.rounds} rounds, {b.decode_dispatches} "
          f"decode calls, {b.decode_steps} slot-steps, launches "
          f"{greedy['counts']}, {engine.compile_count} shape buckets for "
          f"{n_shapes} prompt lengths; cache {cache_bytes / 1e6:.1f} MB at "
          f"one address every round, {live[-1] / 1e9:.3f} GB in use every "
          f"round, peak {peak / 1e9:.3f} GB")

    # fused sampled, every epilogue call kept for the check below
    with _SampleSpy() as spy:
        fused = serve_phase(engine, params, cfg, fused_sampling=True,
                            **serve_cluster.SAMPLING)
    flips = spy.flips()
    n_calls = len(spy.calls)
    # the serving path's own epilogue inputs: where the k-th value falls,
    # and the kernel alone on the first full round's
    under_row, under_slice = [], []
    for inputs, _ in spy.calls:
        rows, fullest = keys_under_first_digit(inputs)
        under_row += rows
        under_slice += fullest
    round_inputs = next(i for i, _ in spy.calls
                        if i["logits"].shape[0] == GEN.n_slots)
    del spy
    check_flips("serving path", serve_cluster.SAMPLING, flips)
    serving_warm, serving_cold = sample_kernel_ms(
        round_inputs, l2_flush_buffer(dev))
    print(f"fused sampled serving path: keys under the k-th value's first "
          f"radix digit over {len(under_row)} rows of {n_calls} epilogue "
          f"calls: per row min {min(under_row)} median "
          f"{sorted(under_row)[len(under_row) // 2]} max {max(under_row)}, "
          f"in the fullest slice max {max(under_slice)}; the kernel alone "
          f"on the first full round's inputs "
          f"{tuple(round_inputs['logits'].shape)} {serving_warm:.4f} ms "
          f"warm, {serving_cold:.4f} ms cold L2")
    # the same seed through the host sampler: the same noise draws
    host = serve_phase(engine, params, cfg, fused_sampling=False,
                       **serve_cluster.SAMPLING)
    differ = [r.rid for r, h in zip(fused["requests"], host["requests"])
              if r.generated != h.generated]
    if len(differ) > len(flips):
        raise AssertionError(f"fused and host streams differ in {differ} "
                             f"with {len(flips)} epilogue flips")
    print(f"generate sampled {serve_cluster.SAMPLING}: fused launches "
          f"{fused['counts']}, {fused['batcher'].sampler_dispatches} "
          f"host-sampler steps; {n_calls} epilogue calls held "
          f"against the plain version: {len(flips)} top-p near-tie flips "
          f"{[round(min(f[1]), 9) for f in flips]}; host-sampled run: "
          f"{host['batcher'].sampler_dispatches} sampler steps, "
          f"{len(differ)} of {len(host['requests'])} streams differ from "
          f"the fused run's")

    # the kernels inside the real model, on one ragged cache
    check = engine.new_cache(GEN.n_slots, GEN.max_len)
    for row, req in enumerate(greedy["requests"][:GEN.n_slots]):
        engine.prefill_into(params, check, row, req.prompt[None])
    token = torch.tensor([[r.generated[0]] for r in
                          greedy["requests"][:GEN.n_slots]], device=dev)
    with torch.no_grad():
        layer_err = decode_layer_errors(cfg, params, clone_cache(check),
                                        token)
    print(f"per-layer decode attention, kernel vs plain on the same input: "
          f"relative RMS error max {max(layer_err):.3g} over "
          f"{len(layer_err)} layers (tol {LAYER_RTOL})")
    if max(layer_err) > LAYER_RTOL:
        raise AssertionError(f"decode attention sublayer disagrees: "
                             f"{layer_err}")
    plain = Engine(model, dataclasses.replace(serve_cluster.RUN,
                                              attn_impl="xla"), device=dev)
    spy_dev = _OutputDevices()
    with spy_dev:
        kern_logits, _ = engine.decode(params, clone_cache(check), token)
    if spy_dev.devices != {dev.type}:
        raise AssertionError(f"activations on {sorted(spy_dev.devices)}")
    plain_logits, _ = plain.decode(params, clone_cache(check), token)
    with decode_attention_in_float64():
        ref_logits, _ = plain.decode(params, clone_cache(check), token)
    noise = float((plain_logits - ref_logits).abs().max())
    bound = NOISE_FACTOR * noise + LOGIT_FLOOR
    logit_err = float((kern_logits - ref_logits).abs().max())
    top_flips = int((kern_logits.argmax(-1) != ref_logits.argmax(-1)).sum())
    plain_flips = int((plain_logits.argmax(-1)
                       != ref_logits.argmax(-1)).sum())
    print(f"decode logits vs float64-attention reference: plain fp32 path "
          f"{noise:.4g} ({plain_flips} argmax flips), kernel path "
          f"{logit_err:.4g} ({top_flips} flips), bound {bound:.4g}")
    if not torch.isfinite(kern_logits).all() or logit_err > bound:
        raise AssertionError(f"kernel path logits {logit_err} > {bound}")

    # timings on the card (CUDA events): one decode round, kernel and plain
    # attention; one admission of the longest prompt
    tok = token.clone()
    decode_ms = cuda_ms(lambda: engine.decode(params, check, tok), iters=5,
                        warmup=1)
    decode_plain_ms = cuda_ms(lambda: plain.decode(params, check, tok),
                              iters=5, warmup=1)
    longest = max(greedy["requests"], key=lambda r: len(r.prompt)).prompt
    prefill_ms = cuda_ms(lambda: engine.prefill_into(
        params, check, 0, longest[None]), iters=3, warmup=1)
    # where a decode round's time goes: device time by kernel, idle share
    prof = profile_round(lambda: engine.decode(params, check, tok))
    busy_ms, launches_per_round = prof["busy_ms"], prof["launches"]
    breakdown = prof["breakdown"]
    decode_kernel_ms = prof["by_name"]["decode_kernel"]
    idle = 1 - busy_ms / decode_ms if busy_ms else None
    print(f"decode round (8 slots, CUDA events): kernel path {decode_ms:.3f}"
          f" ms, plain attention {decode_plain_ms:.3f} ms; prefill of "
          f"{len(longest)} tokens {prefill_ms:.3f} ms; profiled: device busy "
          f"{busy_ms:.3f} ms a round in {launches_per_round:.0f} kernel "
          f"launches ({prof['window_ms']:.3f} ms a round under the "
          f"profiler), idle share of the unprofiled round "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; the "
          f"decode kernel {decode_kernel_ms:.4f} ms of device time a round;"
          f" top kernels (us/round) {breakdown}")

    # a sampled round: where its epilogue's device time goes, the sampling
    # kernel against the torch ops that make its cutoff (softmax, sort,
    # cumsum, top-k) and its noise (uniform, log)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sprof = profile_round(lambda: engine.decode_sample(
        params, check, tok, gen, **serve_cluster.SAMPLING),
        names=("decode_kernel", "sample_kernel"))
    round_logits, _ = engine.decode(params, check, tok)
    epilogue = profile_ops(lambda: fs.fused_sample(
        round_logits, gen, **serve_cluster.SAMPLING))
    epi_kernel_ms = sum(ms for k, ms in epilogue["kernels_ms"].items()
                        if "sample_kernel" in k)
    print(f"sampled decode round (8 slots, {serve_cluster.SAMPLING}), "
          f"profiled: device busy {sprof['busy_ms']:.3f} ms in "
          f"{sprof['launches']:.0f} launches, the sampling kernel "
          f"{sprof['by_name']['sample_kernel']:.4f} ms; its epilogue alone "
          f"{epilogue['busy_ms']:.4f} ms of device time: the kernel "
          f"{epi_kernel_ms:.4f} ms, the cutoff and noise ops "
          f"{epilogue['busy_ms'] - epi_kernel_ms:.4f} ms; by op (ms) "
          f"{json.dumps({k: round(v, 5) for k, v in epilogue['ops_ms'].items()})}"
          f"; by kernel (ms) "
          f"{json.dumps({k: round(v, 5) for k, v in epilogue['kernels_ms'].items()})}")

    def rates(res):
        bk = res["bucket_s"]
        r = res["batcher"]
        return {"wall_s": res["wall_s"], "tokens": res["tokens"],
                "tokens_per_s": res["tokens"] / res["wall_s"],
                "rounds": r.rounds, "admissions": res["admissions"],
                "prefill_ms_per_admission":
                    1e3 * bk["prefill"] / res["admissions"],
                "decode_ms_per_round": 1e3 * (bk["decode_attention"]
                                              + bk["sampler"]) / r.rounds,
                "host_scheduler_s": bk["host_scheduler"],
                "launches": res["counts"]}

    out.update({
        "greedy": rates(greedy), "fused_sampled": rates(fused),
        "host_sampled": rates(host), "compile_count": engine.compile_count,
        "prompt_lengths": n_shapes, "cache_mb": cache_bytes / 1e6,
        "memory_in_use_gb": live[-1] / 1e9, "max_memory_allocated_gb":
        peak / 1e9, "epilogue_calls": n_calls, "top_p_flips": len(flips),
        "serving_keys_under_first_digit_max": max(under_row),
        "serving_round_sample_kernel_ms": [serving_warm, serving_cold],
        "streams_differing_fused_vs_host": len(differ),
        "decode_layer_rel_err_max": max(layer_err),
        "plain_logit_err_vs_fp64": noise, "kernel_logit_err_vs_fp64":
        logit_err, "decode_round_ms": decode_ms,
        "decode_round_plain_attention_ms": decode_plain_ms,
        "prefill_ms_longest": prefill_ms, "round_device_busy_ms": busy_ms,
        "round_kernel_launches": launches_per_round,
        "round_decode_kernel_ms": decode_kernel_ms,
        "profiled_round_wall_ms": prof["window_ms"],
        "idle_share": idle, "round_breakdown_us": breakdown,
        "sampled_round_device_busy_ms": sprof["busy_ms"],
        "sampled_round_sample_kernel_ms": sprof["by_name"]["sample_kernel"],
        "epilogue_device_ms": epilogue["busy_ms"],
        "epilogue_kernel_ms": epi_kernel_ms,
        "epilogue_ops_ms": epilogue["ops_ms"]})
    print("generate " + json.dumps(out))
    counts = {k: greedy["counts"][k] + fused["counts"][k]
              + host["counts"][k] for k in greedy["counts"]}
    return counts, [r.generated for r in greedy["requests"]]


# ---------------------------------------------------------------------------
# Phase (d): the orchestrated generation job, full width, reduced depth
# ---------------------------------------------------------------------------

def run_generation_job(dev) -> tuple:
    """Phase (d): the example's generation job on its card sizes (qwen2-7b
    widths, ``serve_cluster.JOB_LAYERS`` layers). Returns the launch counts
    and the merged tokens."""
    engine, params, prompts = serve_cluster.job_setup(
        configs.get("qwen2-7b"), dev, GEN)
    cfg = engine.model.cfg
    new_tokens = GEN.job_new_tokens
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    job = serve_cluster.run_generation_job(
        engine, params, prompts, batch_size=GEN.job_batch,
        max_new_tokens=new_tokens, concurrency=GEN.job_concurrency,
        max_concurrency=GEN.job_max_concurrency)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    counts = read_counts()
    report = job["report"]
    n_inv = report.n_invocations
    want = dict(NO_LAUNCHES, flash_attention=cfg.n_layers * n_inv,
                decode_attention=cfg.n_layers * n_inv * (new_tokens - 1))
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    if report.extra["committed"] != len(job["chunks"]) or \
            report.n_retries < 1:
        raise AssertionError(f"committed {report.extra['committed']} of "
                             f"{len(job['chunks'])}, {report.n_retries} "
                             f"retries")
    mono = np.concatenate([
        engine.generate(params, prompts[c.start:c.end],
                        max_new_tokens=new_tokens)[:, -new_tokens:]
        for c in job["chunks"]])
    if not np.array_equal(job["tokens"], mono):
        raise AssertionError("merged generations differ from the "
                             "monolithic Engine.generate")
    result = {"arch": cfg.name, "layers": cfg.n_layers,
              "prompts": GEN.job_prompts, "prompt_len": GEN.job_prompt_len,
              "batch_size": GEN.job_batch, "max_new_tokens": new_tokens,
              "concurrency": GEN.job_concurrency,
              "max_concurrency": GEN.job_max_concurrency,
              "chunks": len(job["chunks"]),
              "committed": report.extra["committed"],
              "invocations": n_inv, "crashes": report.n_crashes,
              "retries": report.n_retries,
              "speculative": report.n_speculative,
              "workers": len(job["workers"]),
              "final_concurrency": report.extra["final_concurrency"],
              "wall_s_job_clock": report.wall_time_s, "host_s": host_s,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts}
    print("generation job " + json.dumps(result))
    return counts, job["tokens"]


# ---------------------------------------------------------------------------
# Phase (g): sequence-sharded serving, full width, one rank
# ---------------------------------------------------------------------------

# teacher-forced dense kernel vs seq-shard paths on tamed q/k: the two
# compute the same attention; the seq path's prefill takes the plain path
SEQ_RTOL = 0.02


def seq_serve(engine, params, cfg, reqs, **kw) -> dict:
    """Continuous batching through a seq-shard engine with the launch
    counts read around it: the partials kernel a layer a round and,
    sampled, the sampling kernel once an admission and once a round,
    nothing else (prefill takes the plain path); the cache's tensors at
    one address every round."""
    ptrs = set()
    torch.cuda.synchronize()
    reset_counts()
    res = serve_cluster.serve(
        engine, params, reqs, n_slots=GEN.n_slots, max_len=GEN.max_len,
        seed=SEED, on_round=lambda b: ptrs.add(
            tuple(t.data_ptr() for t in b.cache.tensors())), **kw)
    torch.cuda.synchronize()
    res["counts"] = got = read_counts()
    b = res["batcher"]
    rejected = b.take_rejected()
    if rejected or len(res["completed"]) != len(reqs) or \
            b.decode_dispatches != b.rounds or b.paged:
        raise AssertionError(f"seq-shard serving: {len(rejected)} rejected, "
                             f"{len(res['completed'])} completed, "
                             f"{b.decode_dispatches} decode calls in "
                             f"{b.rounds} rounds, paged {b.paged}")
    want = dict(NO_LAUNCHES,
                decode_attention_partials=cfg.n_layers * b.rounds,
                fused_sample=(len(reqs) + b.rounds if b.fused_sampling
                              else 0))
    if got != want:
        raise AssertionError(f"seq-shard launches {got}, want {want}")
    if b.fused_sampling and b.sampler_dispatches:
        raise AssertionError(f"{b.sampler_dispatches} host-sampler steps "
                             f"with fused sampling")
    if len(ptrs) != 1:
        raise AssertionError("the seq-shard cache moved between rounds")
    res["streams"] = [r.generated for r in reqs]
    return res


def seq_engine(model, dev, mesh=None) -> Engine:
    """The example's mesh engine: ``seq_shard=True`` on a (1, ranks)
    mesh (one rank unless ``mesh`` is given)."""
    return Engine(model, serve_cluster.MESH_RUN, device=dev,
                  mesh=mesh or make_host_mesh((1, 1)), seq_shard=True)


def run_seq_shard(dev) -> tuple:
    """Phase (g): qwen2-7b's widths at SEQ_LAYERS layers through
    ``Engine(mesh=(1, 1),
    seq_shard=True)`` behind ``ContinuousBatcher``: greedy and sampled at
    the reference's init (the main path), then on tamed q/k against the
    dense kernel path (teacher-forced and greedy streams) and a decode
    round on CUDA events. Returns the launch counts, the greedy streams at
    the reference's init and, for phase (h), the near-tie bound."""
    cfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=SEQ_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    engine = seq_engine(model, dev)
    if engine.run.attn_impl != "seq_shard":
        raise AssertionError(f"attn_impl {engine.run.attn_impl}")

    def requests():
        return serve_cluster.make_requests(cfg.vocab_size, GEN.n_requests,
                                           GEN.prompt_len, GEN.new_tokens,
                                           SEED)

    greedy = seq_serve(engine, params, cfg, requests())
    sampled = seq_serve(engine, params, cfg, requests(), fused_sampling=True,
                        **serve_cluster.SAMPLING)
    counts = {k: greedy["counts"][k] + sampled["counts"][k]
              for k in greedy["counts"]}
    block = tuple(greedy["batcher"].cache.layers[0]["k"].shape)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1,
           "model": 1}, "cache_block": block, "seed": SEED}
    for name, res in (("greedy", greedy), ("sampled", sampled)):
        b = res["batcher"]
        out[name] = {"rounds": b.rounds, "tokens": res["tokens"],
                     "wall_s": res["wall_s"],
                     "tokens_per_s": res["tokens"] / res["wall_s"],
                     "sampler_dispatches": b.sampler_dispatches,
                     "launches": res["counts"]}
    print(f"(g) seq-shard serving at the reference's init, mesh (1, 1), "
          f"cache block {block}: greedy {json.dumps(out['greedy'])}; "
          f"sampled {json.dumps(out['sampled'])}")

    # tamed q/k: the seq-shard path against the dense kernel path,
    # teacher-forced, first from the same admitted K/V (the decode paths
    # alone: at one shard the partials loop is the dense kernel's), then
    # each path admitting its own rows (its prefill: plain attention
    # against the flash kernel, so flips at near-ties may appear)
    tame_attention(cfg, params)
    dense = Engine(model, serve_cluster.RUN, device=dev)
    batch = requests()[:GEN.n_slots]
    cache, logits = admit_rows(dense, params, batch, False)
    tf = teacher_forced([(dense, False), (engine, False)], params, batch,
                        TEACHER_ROUNDS, admitted=((cache, logits), (
                            clone_cache(cache), logits.clone())))
    del cache
    tf_own = teacher_forced([(dense, False), (engine, False)], params,
                            batch, TEACHER_ROUNDS)
    for name, r in (("decode paths, same admitted K/V", tf),
                    ("whole paths, each its own prefill", tf_own)):
        print(f"(g) tamed q/k, dense kernel vs seq-shard {name}, "
              f"teacher-forced {TEACHER_ROUNDS} rounds on {GEN.n_slots} "
              f"rows: {r['flips']} argmax flips in {r['rows']} rows, max "
              f"|logit diff| {r['max_abs_diff']:.4g}, relative RMS "
              f"{r['rel_rms']:.4g} (tol {SEQ_RTOL})")
    if tf["rel_rms"] > SEQ_RTOL or tf["flips"] or \
            tf_own["rel_rms"] > SEQ_RTOL:
        raise AssertionError(f"seq-shard vs dense kernel path: {tf}, "
                             f"{tf_own}")
    reqs = requests()
    torch.cuda.synchronize()
    dense_res = serve_cluster.serve(dense, params, reqs, n_slots=GEN.n_slots,
                                    max_len=GEN.max_len, seed=SEED)
    dense_streams = [r.generated for r in reqs]
    tamed = seq_serve(engine, params, cfg, requests())
    for k in counts:
        counts[k] += tamed["counts"][k]
    tie = NOISE_FACTOR * tf_own["max_abs_diff"] + LOGIT_FLOOR
    prompts = [r.prompt for r in reqs]
    parted = parted_at_near_ties(dense, params, prompts, dense_streams,
                                 tamed["streams"], tie)
    print(f"(g) tamed greedy streams, seq-shard vs dense kernel path: "
          f"{parted} of {len(reqs)} parted, all at near-ties (bound "
          f"{tie:.4g}); dense run {dense_res['batcher'].rounds} rounds, "
          f"seq-shard run {tamed['batcher'].rounds}")

    # one decode round on CUDA events, in turns with the dense path
    caches = {"dense": (dense, admit_rows(dense, params, batch, False)[0]),
              "seq_shard": (engine, admit_rows(engine, params, batch,
                                               False)[0])}
    tok = torch.tensor([[r.prompt[-1]] for r in batch], device=dev,
                       dtype=torch.int32)
    times = {name: [] for name in caches}
    for name in ("dense", "seq_shard", "seq_shard", "dense"):
        eng, cache = caches[name]
        times[name].append(cuda_ms(lambda: eng.decode(params, cache, tok),
                                   iters=5, warmup=1))
    rounds = {}
    for name, (eng, cache) in caches.items():
        ms = sum(times[name]) / len(times[name])
        prof = profile_round(lambda: eng.decode(params, cache, tok))
        rounds[name] = {"ms": ms, "ms_turns": times[name],
                        "busy_ms": prof["busy_ms"],
                        "launches": prof["launches"],
                        "idle_share": 1 - prof["busy_ms"] / ms,
                        "top_kernels_us": prof["breakdown"]}
        print(f"(g) decode round {name}: {ms:.3f} ms on CUDA events (turns "
              f"{[round(t, 3) for t in times[name]]}), device busy "
              f"{prof['busy_ms']:.3f} ms in {prof['launches']:.0f} launches,"
              f" idle share {1 - prof['busy_ms'] / ms:.3f}; top kernels "
              f"(us/round) {prof['breakdown']}")
    del caches
    out.update(teacher_forced_decode=tf, teacher_forced_whole=tf_own,
               near_tie_bound=tie, streams_parted=parted,
               decode_round=rounds, launches=counts)
    print("seq_shard " + json.dumps(out))
    return counts, greedy["streams"], {"tie": tie}


# ---------------------------------------------------------------------------
# Phase (e): the example's entry point, as a user runs it
# ---------------------------------------------------------------------------


def run_entry_point(dev, greedy_streams, job_tokens) -> dict:
    """``serve_cluster.run``, the body of ``serve_cluster.main``, on the
    card with qwen2-7b at phase (g)'s SEQ_LAYERS: every request served
    through the one-rank seq-shard mesh in one decode call a round, the
    launches its runs imply, and the same greedy streams and job tokens as
    phases (g) and (d), which took its sizes."""
    torch.cuda.synchronize()
    reset_counts()
    out = serve_cluster.run(dev, dataclasses.replace(
        configs.get("qwen2-7b"), n_layers=SEQ_LAYERS))
    torch.cuda.synchronize()
    counts = read_counts()
    n_layers = SEQ_LAYERS
    want = dict.fromkeys(counts, 0)
    for mode in ("greedy", "sampled"):
        res = out[mode]
        b = res["batcher"]
        admissions = len(res["requests"]) - len(b.take_rejected())
        if len(res["completed"]) != GEN.n_requests or \
                admissions != GEN.n_requests or \
                b.decode_dispatches != b.rounds:
            raise AssertionError(f"{mode}: {len(res['completed'])} completed,"
                                 f" {admissions} admitted, "
                                 f"{b.decode_dispatches} decode calls in "
                                 f"{b.rounds} rounds")
        # the mesh path: plain prefill, the partials kernel every round,
        # sampled: the sampling kernel every admission and round
        want["decode_attention_partials"] += n_layers * b.decode_dispatches
        if b.fused_sampling:
            want["fused_sample"] += admissions + b.decode_dispatches
        if b.fused_sampling and b.sampler_dispatches:
            raise AssertionError(f"{b.sampler_dispatches} host-sampler "
                                 f"steps with fused sampling")
    n_inv = out["job"]["report"].n_invocations
    want["flash_attention"] += serve_cluster.JOB_LAYERS * n_inv
    want["decode_attention"] += (serve_cluster.JOB_LAYERS * n_inv
                                 * (GEN.job_new_tokens - 1))
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    streams = [r.generated for r in out["greedy"]["requests"]]
    if streams != greedy_streams:
        raise AssertionError("the entry point's greedy streams differ from "
                             "phase (g)'s")
    if not np.array_equal(out["job"]["tokens"], job_tokens):
        raise AssertionError("the entry point's job tokens differ from "
                             "phase (d)'s")
    print(f"entry point serve_cluster.run at {SEQ_LAYERS} layers: "
          f"launches {counts}; greedy "
          f"streams and job tokens equal phases (g) and (d)")
    return counts


# ---------------------------------------------------------------------------
# Phase (f): paged and int8 serving at full width
# ---------------------------------------------------------------------------

PAGED = serve_cluster.PAGED_CARD_SIZES
# qwen2-7b's widths at PAGED_LAYERS of its 28 layers, cut from 28 to make
# room for phase (s)
PAGED_LAYERS = 8
TEACHER_ROUNDS = 32
FORK_STEPS = 16


class _PlanSpy:
    """Keeps every ``PageAllocator.admit`` plan of a run."""

    def __init__(self):
        self.plans = []
        self.admit = PageAllocator.admit

    def __enter__(self):
        spy = self

        def admit(alloc, *args, **kw):
            plan = spy.admit(alloc, *args, **kw)
            spy.plans.append(plan)
            return plan

        PageAllocator.admit = admit
        return self

    def __exit__(self, *exc):
        PageAllocator.admit = self.admit


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| over every element, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def admit_rows(engine, params, reqs, paged: bool):
    """A fresh cache (8 slots, PAGED sizes) with ``reqs`` admitted into rows
    0.. as the batcher admits them: ``prefill_into`` dense; allocator plan,
    ``assign_row_pages`` and ``extend_row`` paged. Returns (cache, the
    admissions' logits (n, V))."""
    max_pages = PAGED.max_len // PAGED.page_size
    if paged:
        alloc = PageAllocator(1 + PAGED.n_slots * max_pages,
                              PAGED.page_size, max_pages)
        cache = engine.new_paged_cache(PAGED.n_slots, alloc.n_pages,
                                       PAGED.page_size, max_pages)
    else:
        cache = engine.new_cache(PAGED.n_slots, PAGED.max_len)
    logits = []
    for row, req in enumerate(reqs):
        if paged:
            plan = alloc.admit(row, req.prompt, req.max_new_tokens)
            cache = engine.assign_row_pages(cache, row, plan.pages,
                                            plan.start_len)
            lg, cache = engine.extend_row(params, cache, row,
                                          plan.suffix[None])
        else:
            lg, cache = engine.prefill_into(params, cache, row,
                                            req.prompt[None])
        logits.append(lg)
    return cache, torch.cat(logits)


def teacher_forced(engines, params, reqs, rounds,
                   near_ties_only: bool = True, admitted=None) -> dict:
    """The same rows through two engine paths, decoded ``rounds`` rounds on
    the FIRST path's greedy tokens (teacher forcing). With
    ``near_ties_only`` each argmax flip must be a near-tie: the first
    path's top-2 gap at most twice that round's max |logit difference|
    (``tests/test_kv_int8.py``'s rule). ``admitted`` gives both paths'
    caches and admission logits instead of admitting ``reqs`` through
    each. Returns the flips, the max difference and the logits' relative
    RMS."""
    (a_eng, a_paged), (b_eng, b_paged) = engines
    if admitted is None:
        ca, la = admit_rows(a_eng, params, reqs, a_paged)
        cb, lb = admit_rows(b_eng, params, reqs, b_paged)
    else:
        (ca, la), (cb, lb) = admitted
    pairs, flips, hard = [(la, lb)], 0, []
    tok = la.argmax(-1).to(torch.int32)[:, None]
    for step in range(rounds):
        la, ca = a_eng.decode(params, ca, tok)
        lb, cb = b_eng.decode(params, cb, tok)
        pairs.append((la, lb))
        delta = float((la - lb).abs().max())
        for row in range(la.shape[0]):
            if int(la[row].argmax()) != int(lb[row].argmax()):
                flips += 1
                top2 = torch.topk(la[row], 2).values
                gap = float(top2[0] - top2[1])
                if gap > 2 * delta:
                    hard.append((step, row, gap, delta))
        tok = la.argmax(-1).to(torch.int32)[:, None]
    a = torch.stack([p[0] for p in pairs])
    b = torch.stack([p[1] for p in pairs])
    if hard and near_ties_only:
        raise AssertionError(f"argmax flips past near-ties: {hard}")
    return {"flips": flips, "rows": int(a.shape[0] * a.shape[1]),
            "max_abs_diff": float((a - b).abs().max()),
            "rel_rms": rel_rms(b, a)}


def parted_at_near_ties(engine, params, prompts, want, got, tie) -> int:
    """Streams equal token for token, or parted where both tokens lie
    within ``tie`` of the best logit of ``engine`` (a fresh prefill of the
    prompt and the common tokens) at the first difference. Returns how many
    parted; raises at a parting that is not a near-tie."""
    parted = 0
    for prompt, a, b in zip(prompts, want, got):
        if len(a) != len(b):
            raise AssertionError(f"stream lengths {len(a)} vs {len(b)}")
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = np.concatenate([np.asarray(prompt), a[:i]]).astype(np.int32)
        logits, _ = engine.prefill(params, seq[None])
        best = float(logits[0].max())
        gaps = (best - float(logits[0, a[i]]), best - float(logits[0, b[i]]))
        if max(gaps) > tie:
            raise AssertionError(f"stream parts at token {i} ({a[i]} vs "
                                 f"{b[i]}) with logit gaps {gaps} > {tie}")
        parted += 1
    return parted


def fork_divergence(engine, params, req) -> dict:
    """Best-of-2 on the paged cache: admit ``req`` into row 0, fork it into
    row 1 (``fork_row``: no KV copied), force a different first token
    there, and decode both rows in the same calls for FORK_STEPS rounds,
    running the copy-on-write barrier before each. Returns both branches'
    tokens, the barrier's copies and the two rows' pages."""
    max_pages = PAGED.max_len // PAGED.page_size
    alloc = PageAllocator(1 + PAGED.n_slots * max_pages, PAGED.page_size,
                          max_pages)
    cache = engine.new_paged_cache(PAGED.n_slots, alloc.n_pages,
                                   PAGED.page_size, max_pages)
    plan = alloc.admit(0, req.prompt, FORK_STEPS + 1)
    cache = engine.assign_row_pages(cache, 0, plan.pages, plan.start_len)
    logits, cache = engine.extend_row(params, cache, 0, plan.suffix[None])
    t0 = int(logits[0].argmax())
    t1 = next(t for t in torch.topk(logits[0], 2).indices.tolist()
              if t != t0)  # the runner-up
    alloc.fork(0, 1)
    cache = engine.fork_row(cache, 0, 1)
    n = len(req.prompt)
    host_len = {0: n, 1: n}
    toks = np.zeros((PAGED.n_slots, 1), np.int32)
    toks[:2, 0] = (t0, t1)
    out, cows = {0: [t0], 1: [t1]}, []
    for _ in range(FORK_STEPS):
        for row in (0, 1):
            cow = alloc.writable_page(row, host_len[row])
            if cow is not None:
                cows.append(cow)
                cache = engine.cow_copy_page(cache, *cow)
                cache = engine.assign_row_pages(cache, row, alloc.rows[row],
                                                host_len[row])
        logits, cache = engine.decode(params, cache, toks)
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        for row in (0, 1):
            out[row].append(int(nxt[row]))
            host_len[row] += 1
        toks[:2, 0] = nxt[:2]
    return {"branches": out, "cows": cows, "pages": (alloc.rows[0],
                                                     alloc.rows[1])}


def independent_decode(engine, params, prompt, steps) -> list:
    """Greedy tokens of ``prompt`` alone in row 0 of a fresh paged cache
    (the same 8-row decode calls): the first from its admission, then
    ``steps`` decoded ones."""
    req = Request(0, np.asarray(prompt, np.int32), steps + 1)
    cache, logits = admit_rows(engine, params, [req], paged=True)
    tok = int(logits[0].argmax())
    out = [tok]
    toks = np.zeros((PAGED.n_slots, 1), np.int32)
    for _ in range(steps):
        toks[0, 0] = tok
        logits, cache = engine.decode(params, cache, toks)
        tok = int(logits[0].argmax())
        out.append(tok)
    return out


def paged_layer_errors(cfg, params, cache, token) -> list:
    """Per layer: relative RMS error between the paged decode attention
    sublayer through the kernel and through the plain path, both fed the
    plain path's hidden state (each writes the same k/v into the pools)."""
    lengths = cache.lengths
    x = transformer._embed_in(cfg, params, token, None,
                              lengths[:, None].long())
    errs = []
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        h = apply_norm(cfg, p["norm1"], x)
        ys = [attention.attn_decode_layer_paged(
            cfg, p["attn"], h, c["k"], c["v"], cache.page_table, lengths,
            mixer=spec.mixer, page_size=cache.page_size, impl=impl,
            k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))[0].float()
            for impl in ("pallas", "xla")]
        errs.append(rel_rms(ys[0], ys[1]))
        x = transformer._mlp_residual(
            cfg, RunConfig(), spec, p,
            transformer._mixer_residual(cfg, p, x, ys[1].to(x.dtype)))[0]
    return errs


def clone_paged(cache: PagedCache) -> PagedCache:
    return PagedCache(layers=tuple({n: t.clone() for n, t in layer.items()}
                                   for layer in cache.layers),
                      page_table=cache.page_table.clone(),
                      lengths=cache.lengths.clone(),
                      page_size=cache.page_size)


def tame_attention(cfg, params):
    """Rescale every layer's q and k projections IN PLACE to the std
    1/sqrt(d_model) of a fan-in init. The reference's init takes fan_in =
    shape[-2], the head count, for the (d_model, heads, head_dim) kernels
    (ROADMAP Queue 3), so at full width qwen2-7b's attention logits have
    a std near 340 and the softmax is an argmax: one bf16 ulp anywhere
    flips it somewhere, and two correct implementations (the dense
    kernel and plain decode paths) give uncorrelated logits (relative RMS
    1.18 on an H100). At this scale they agree to 0.007, so phase (f) can
    hold one serving path to another."""
    d = cfg.d_model
    for p in params["blocks"]:
        if "attn" in p:  # an SSM layer has no q/k
            p["attn"]["wq"].mul_(math.sqrt(cfg.n_heads / d))
            p["attn"]["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))


def paged_copy(engine, cache, seed: int = 0) -> PagedCache:
    """A paged cache (pages of PAGED.page_size, a shuffled pool) holding
    exactly ``cache``'s rows, lengths and values: the paged path over the
    dense path's own KV."""
    ps = PAGED.page_size
    b, t = cache.layers[0]["k"].shape[:2]
    max_pages = t // ps
    n_pages = 1 + b * max_pages
    paged = engine.new_paged_cache(b, n_pages, ps, max_pages)
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(b, max_pages).to(cache.lengths.device)
    paged.page_table.copy_(table)
    paged.lengths.copy_(cache.lengths)
    for dense, pools in zip(cache.layers, paged.layers):
        for name, t_ in dense.items():
            pools[name][table] = t_.reshape(b, max_pages, ps, *t_.shape[2:])
    return paged


def kv_bytes_per_token(cache) -> float:
    """KV bytes a cached token costs, summed over layers (values and
    scales): the cache's layer tensors over its token slots."""
    k = cache.layers[0]["k"]
    slots = k.shape[0] * k.shape[1]
    return sum(t.numel() * t.element_size() for layer in cache.layers
               for t in layer.values()) / slots


def run_paged_int8(dev) -> dict:
    """Phase (f): qwen2-7b's widths at PAGED_LAYERS layers on the
    shared-prefix workload, dense int8, paged bf16, paged int8 and paged
    int8 fused-sampled, beside a dense bf16 run; returns the launch counts
    of its serving runs."""
    cfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=PAGED_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    engines = {"bf16": Engine(model, serve_cluster.RUN, device=dev),
               "int8": Engine(model, dataclasses.replace(
                   serve_cluster.RUN, kv_dtype="int8"), device=dev)}
    plain = Engine(model, dataclasses.replace(serve_cluster.RUN,
                                              attn_impl="xla"), device=dev)
    batch = serve_cluster.make_prefix_requests(cfg.vocab_size, PAGED,
                                               SEED)[:PAGED.n_slots]
    # why the attention is tamed: at the reference's init two correct
    # implementations (the dense kernel and plain paths) part ways
    chaos = teacher_forced([(engines["bf16"], False), (plain, False)],
                           params, batch, 8, near_ties_only=False)
    print(f"(f) at the reference's init, dense kernel vs plain bf16, "
          f"teacher-forced 8 rounds: {chaos['flips']} argmax flips in "
          f"{chaos['rows']} rows, max |logit diff| "
          f"{chaos['max_abs_diff']:.4g}, relative RMS {chaos['rel_rms']:.4g}"
          f"; the rest of phase (f) draws q and k at fan_in = d_model")
    tame_attention(cfg, params)
    n_layers = cfg.n_layers
    out = {"arch": cfg.name, "layers": n_layers,
           "sizes": dataclasses.asdict(PAGED), "seed": SEED}
    kernel_of = {("bf16", False): "decode_attention",
                 ("int8", False): "decode_attention_quant",
                 ("bf16", True): "paged_decode_attention",
                 ("int8", True): "paged_decode_attention_quant"}
    counts = dict(NO_LAUNCHES)

    def serve_run(kv, paged, **kw):
        reqs = serve_cluster.make_prefix_requests(cfg.vocab_size, PAGED,
                                                  SEED)
        ptrs, live = set(), []

        def on_round(b):
            ptrs.add(tuple(t.data_ptr() for t in b.cache.tensors()))
            if b.allocator is not None:
                live.append(b.allocator.n_live)

        torch.cuda.synchronize()
        reset_counts()
        with _PlanSpy() as spy:
            res = serve_cluster.serve(
                engines[kv], params, reqs, n_slots=PAGED.n_slots,
                max_len=PAGED.max_len, seed=SEED, on_round=on_round,
                paged=paged, page_size=PAGED.page_size, **kw)
        torch.cuda.synchronize()
        got = read_counts()
        for k, v in got.items():
            counts[k] += v
        b = res["batcher"]
        rejected = b.take_rejected()
        admissions = len(reqs) - len(rejected)
        if rejected or len(res["completed"]) != len(reqs) or \
                b.decode_dispatches != b.rounds or b.paged != paged:
            raise AssertionError(f"{kv} paged={paged}: {len(rejected)} "
                                 f"rejected, {len(res['completed'])} "
                                 f"completed, {b.decode_dispatches} decode "
                                 f"calls in {b.rounds} rounds")
        want = dict(NO_LAUNCHES)
        want[kernel_of[kv, paged]] = n_layers * b.rounds
        if not paged:
            want["flash_attention"] = n_layers * admissions
        if b.fused_sampling:
            want["fused_sample"] = admissions + b.rounds
            if b.sampler_dispatches:
                raise AssertionError(f"{b.sampler_dispatches} host-sampler "
                                     f"steps with fused sampling")
        if got != want:
            raise AssertionError(f"{kv} paged={paged}: launches {got}, "
                                 f"want {want}")
        if len(ptrs) != 1:
            raise AssertionError(f"{kv} paged={paged}: the cache's tensors "
                                 f"moved between rounds")
        r = {"rounds": b.rounds, "admissions": admissions,
             "tokens": res["tokens"], "wall_s": res["wall_s"],
             "tokens_per_s": res["tokens"] / res["wall_s"],
             "decode_ms_per_round": 1e3 * (res["bucket_s"]["decode_attention"]
                                           + res["bucket_s"]["sampler"])
             / b.rounds,
             "prefill_ms_per_admission": 1e3 * res["bucket_s"]["prefill"]
             / admissions, "launches": got}
        if paged:
            shared = [p.n_shared for p in spy.plans]
            r.update(warm=sum(n == PAGED.prefix_len // PAGED.page_size
                              for n in shared),
                     n_shared=shared, peak_live_pages=max(live),
                     pool_pages=b.allocator.n_pages)
        print(f"(f) {kv} {'paged' if paged else 'dense'}"
              f"{' fused-sampled' if b.fused_sampling else ''}: "
              f"{json.dumps({k: v for k, v in r.items() if k != 'n_shared'})}")
        return reqs, r, b

    dense16, out["dense_bf16"], _ = serve_run("bf16", False)
    dense8, out["dense_int8"], b8 = serve_run("int8", False)
    paged16, out["paged_bf16"], _ = serve_run("bf16", True)
    paged8, out["paged_int8"], _ = serve_run("int8", True)
    _, out["paged_int8_fused"], _ = serve_run(
        "int8", True, fused_sampling=True, **serve_cluster.SAMPLING)
    n_req = PAGED.n_groups * PAGED.group_size
    want_warm = n_req - PAGED.n_groups
    for key in ("paged_bf16", "paged_int8", "paged_int8_fused"):
        if out[key]["warm"] != want_warm:
            raise AssertionError(f"{key}: {out[key]['warm']} warm "
                                 f"admissions, want {want_warm}: "
                                 f"{out[key]['n_shared']}")
    print(f"(f) prefix sharing: {want_warm} of {n_req} admissions share "
          f"{PAGED.prefix_len // PAGED.page_size} pages in each paged run; "
          f"peak live pages {out['paged_bf16']['peak_live_pages']} of a "
          f"worst-case pool of {out['paged_bf16']['pool_pages']}")

    # KV bytes per token: int8 (values + scales) against bf16
    c16 = engines["bf16"].new_cache(1, 1)
    c8 = engines["int8"].new_cache(1, 1)
    out["kv_bytes_per_token"] = {"bf16": kv_bytes_per_token(c16),
                                 "int8": kv_bytes_per_token(c8)}
    ratio = out["kv_bytes_per_token"]["int8"] / \
        out["kv_bytes_per_token"]["bf16"]
    print(f"(f) KV bytes per token: int8 "
          f"{out['kv_bytes_per_token']['int8']:.0f}, bf16 "
          f"{out['kv_bytes_per_token']['bf16']:.0f} ({ratio:.3f}x)")
    if out["kv_bytes_per_token"] != {"bf16": 2.0 * 2 * cfg.n_kv_heads
                                     * cfg.head_dim * n_layers,
                                     "int8": 2.0 * cfg.n_kv_heads
                                     * (cfg.head_dim + 4) * n_layers}:
        raise AssertionError(f"KV bytes {out['kv_bytes_per_token']}")

    # two serving paths on the same rows, teacher-forced: the yardstick is
    # the dense kernel vs plain paths (two correct implementations)
    tf = {}
    for name, pair in (
            ("dense_kernel_vs_plain_bf16", ((engines["bf16"], False),
                                            (plain, False))),
            ("paged_vs_dense_bf16", ((engines["bf16"], False),
                                     (engines["bf16"], True))),
            ("paged_vs_dense_int8", ((engines["int8"], False),
                                     (engines["int8"], True))),
            ("int8_vs_bf16_dense", ((engines["bf16"], False),
                                    (engines["int8"], False)))):
        tf[name] = teacher_forced(pair, params, batch, TEACHER_ROUNDS)
        print(f"(f) {name}, teacher-forced {TEACHER_ROUNDS} rounds on "
              f"{PAGED.n_slots} rows: {tf[name]['flips']} argmax flips in "
              f"{tf[name]['rows']} rows (all near-ties), max |logit diff| "
              f"{tf[name]['max_abs_diff']:.4g}, relative RMS "
              f"{tf[name]['rel_rms']:.4g} (tol {PATH_RTOL})")
        if tf[name]["rel_rms"] > PATH_RTOL:
            raise AssertionError(f"{name}: logits drift: {tf[name]}")
    tie = {kv: NOISE_FACTOR * tf[f"paged_vs_dense_{kv}"]["max_abs_diff"]
           + LOGIT_FLOOR for kv in ("bf16", "int8")}
    prompts = [r.prompt for r in dense16]
    parted16 = parted_at_near_ties(
        engines["bf16"], params, prompts, [r.generated for r in dense16],
        [r.generated for r in paged16], tie["bf16"])
    parted8 = parted_at_near_ties(
        engines["int8"], params, prompts, [r.generated for r in dense8],
        [r.generated for r in paged8], tie["int8"])
    print(f"(f) greedy streams: paged bf16 vs dense bf16 {parted16} of "
          f"{n_req} parted, paged int8 vs dense int8 {parted8} parted, all "
          f"at near-ties (bounds {tie['bf16']:.4g}, {tie['int8']:.4g})")
    out.update(teacher_forced=tf, near_tie_bound=tie,
               teacher_forced_reference_init=chaos,
               streams_parted_paged_bf16=parted16,
               streams_parted_paged_int8=parted8)

    # the paged path over the dense path's own KV: bit for bit
    for kv in ("bf16", "int8"):
        eng = engines[kv]
        dense, logits = admit_rows(eng, params, batch, paged=False)
        paged = paged_copy(eng, dense)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        for step in range(8):
            ld, _ = eng.decode(params, dense, tok)
            lp, _ = eng.decode(params, paged, tok)
            if not torch.equal(ld, lp):
                raise AssertionError(f"{kv}: paged decode over the dense "
                                     f"cache's KV differs at round {step}: "
                                     f"{float((ld - lp).abs().max())}")
            tok = ld.argmax(-1).to(torch.int32)[:, None]
        del dense, paged
    print("(f) paged decode over a shuffled-pool copy of a dense cache: "
          "logits equal the dense decode's bit for bit, 8 rounds, bf16 and "
          "int8")

    # fork + copy-on-write at full width vs independent decodes
    fork = fork_divergence(engines["bf16"], params, batch[0])
    n = len(batch[0].prompt)
    (p0, p1), n_full = fork["pages"], n // PAGED.page_size
    # row 0 writes first each round, so it copies every shared page it
    # writes into; the full prompt pages stay shared
    written = sorted({pos // PAGED.page_size
                      for pos in range(n, n + FORK_STEPS)})
    if len(fork["cows"]) != len(written) or p0[:n_full] != p1[:n_full] or \
            any(p0[i] == p1[i] for i in written):
        raise AssertionError(f"copy-on-write: {fork['cows']} copies for "
                             f"pages {written}, pages {p0} / {p1}")
    ind0 = independent_decode(engines["bf16"], params, batch[0].prompt,
                              FORK_STEPS)
    forced = np.concatenate([batch[0].prompt, [fork["branches"][1][0]]])
    ind1 = independent_decode(engines["bf16"], params, forced,
                              FORK_STEPS - 1)
    parted_fork = parted_at_near_ties(
        engines["bf16"], params, [batch[0].prompt, forced],
        [ind0, ind1], [fork["branches"][0], fork["branches"][1][1:]],
        tie["bf16"])
    print(f"(f) fork_row + copy-on-write: {len(fork['cows'])} pages copied "
          f"{fork['cows']}, {n_full} full pages still shared; branches "
          f"vs independent decodes: {parted_fork} of 2 parted (near-ties), "
          f"branch 0 equal: {fork['branches'][0] == ind0}")
    out["fork_branches_parted"] = parted_fork

    # the kernels inside the real model: each paged layer, kernel vs plain
    cache8, _ = admit_rows(engines["int8"], params, batch, paged=True)
    token = torch.tensor([[r.prompt[-1]] for r in batch], device=dev)
    with torch.no_grad():
        layer_err = paged_layer_errors(cfg, params, clone_paged(cache8),
                                       token)
    print(f"(f) per-layer paged int8 decode attention, kernel vs plain on "
          f"the same input: relative RMS max {max(layer_err):.3g} over "
          f"{len(layer_err)} layers (tol {LAYER_RTOL})")
    if max(layer_err) > LAYER_RTOL:
        raise AssertionError(f"paged int8 sublayer disagrees: {layer_err}")

    # decode round times on CUDA events, one cache of each layout, timed in
    # turns (each layout twice, in the order ABCD DCBA) so drift of the
    # shared host falls on all four alike
    tok = token.to(torch.int32)
    layouts = {}
    for kv in ("bf16", "int8"):
        for paged in (False, True):
            cache, _ = admit_rows(engines[kv], params, batch, paged)
            layouts[f"{'paged' if paged else 'dense'}_{kv}"] = (
                engines[kv], cache)
    times = {name: [] for name in layouts}
    for name in list(layouts) + list(reversed(layouts)):
        eng, cache = layouts[name]
        times[name].append(cuda_ms(lambda: eng.decode(params, cache, tok),
                                   iters=5, warmup=1))
    rounds = {}
    for name, (eng, cache) in layouts.items():
        ms = sum(times[name]) / len(times[name])
        prof = profile_round(lambda: eng.decode(params, cache, tok))
        rounds[name] = {"ms": ms, "ms_turns": times[name],
                        "busy_ms": prof["busy_ms"],
                        "launches": prof["launches"],
                        "idle_share": 1 - prof["busy_ms"] / ms,
                        "top_kernels_us": prof["breakdown"]}
        print(f"(f) decode round {name}: {ms:.3f} ms on CUDA events (turns "
              f"{[round(t, 3) for t in times[name]]}), device busy "
              f"{prof['busy_ms']:.3f} ms in {prof['launches']:.0f} launches,"
              f" idle share {1 - prof['busy_ms'] / ms:.3f}; top kernels "
              f"(us/round) {prof['breakdown']}")
    del layouts
    out["decode_round"] = rounds
    out["launches"] = counts
    print("paged_int8 " + json.dumps(out))
    return counts


# ---------------------------------------------------------------------------
# Phase (h): seq-sharded serving on ranks that share the card
# ---------------------------------------------------------------------------

# (name, ranks, layers, requests): two ranks at RANK2_LAYERS layers on the
# card sizes, then four at RANK4_LAYERS layers on fewer requests (the only
# run where one row spans more than two shards), each held to one device
# within the near-tie bound phase (g) measured at (g)'s depth. RANK4_LAYERS
# was the job's 4 until phase (r) took the script past 85% of its time
# limit (1 031 s on an H100 with 4); the two ranks ran all 28 layers until
# phase (u) joined a script at 93% of its limit (1 112.3 s, PERF.md §6)
RANK2_LAYERS = SEQ_LAYERS
RANK4_LAYERS = 2
RANK_RUNS = [(f"seq_shard_qwen2_7b_{RANK2_LAYERS}_layers_2_ranks", 2,
              RANK2_LAYERS, GEN.n_requests),
             (f"seq_shard_qwen2_7b_{RANK4_LAYERS}_layers_4_ranks", 4,
              RANK4_LAYERS, 8)]
RANK_TIMEOUT_S = 600


def rank_worker(spec_path: str):
    """One rank of phase (h), started by ``launch.mesh.spawn_ranks``: the
    tamed model (seed ``SEED``) on a (1, ranks) seq-shard mesh, gloo on the
    shared card; continuous batching with its launch counts, the cache's
    block and address, a decode round on CUDA events, and the time spent
    in all_reduce per round. Rank 0 also holds the streams to a
    single-device dense kernel run of the same model at near-ties, within
    the bound phase (g) measured. Writes its result as JSON beside the
    spec."""
    spec = json.loads(Path(spec_path).read_text())
    dev = init_from_env("cuda")
    rank, world = rank_env()
    cfg = dataclasses.replace(configs.get("qwen2-7b"),
                              n_layers=spec["layers"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    tame_attention(cfg, params)
    engine = seq_engine(model, dev, make_host_mesh((1, world)))
    reqs = serve_cluster.make_requests(cfg.vocab_size, spec["n_requests"],
                                       GEN.prompt_len, GEN.new_tokens, SEED)
    res = seq_serve(engine, params, cfg, reqs)
    b = res["batcher"]
    block = tuple(b.cache.layers[0]["k"].shape)
    want_block = (GEN.n_slots, GEN.max_len // world, cfg.n_kv_heads,
                  cfg.head_dim)
    if block != want_block or b.cache.seq_shards != world:
        raise AssertionError(f"rank {rank}: cache block {block} of "
                             f"{b.cache.seq_shards}, want {want_block}")

    # a decode round: CUDA events, then a pass timing each all_reduce
    # (synchronised around it) inside host-clock rounds
    batch = reqs[:GEN.n_slots]
    cache, _ = admit_rows(engine, params, batch, False)
    tok = torch.tensor([[r.prompt[-1]] for r in batch], device=dev,
                       dtype=torch.int32)
    round_ms = cuda_ms(lambda: engine.decode(params, cache, tok), iters=5,
                       warmup=1)
    spent = []
    plain_all_reduce = collectives._all_reduce

    def timed_all_reduce(t, op, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_all_reduce(t, op, group)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return t

    n = 5
    collectives._all_reduce = timed_all_reduce
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.decode(params, cache, tok)
        torch.cuda.synchronize()
        timed_round_ms = 1e3 * (time.perf_counter() - t0) / n
    finally:
        collectives._all_reduce = plain_all_reduce
    prof = profile_round(lambda: engine.decode(params, cache, tok))
    del cache
    dense = Engine(model, serve_cluster.RUN, device=dev)
    tie = spec["tie"]
    out = {"rank": rank, "ranks": world, "layers": cfg.n_layers,
           "requests": len(reqs), "rounds": b.rounds,
           "tokens": res["tokens"], "wall_s": res["wall_s"],
           "tokens_per_s": res["tokens"] / res["wall_s"],
           "cache_block": block, "launches": res["counts"],
           "streams": res["streams"], "round_ms": round_ms,
           "all_reduce_calls_per_round": len(spent) / n,
           "all_reduce_ms_per_round": 1e3 * sum(spent) / n,
           "timed_round_ms": timed_round_ms,
           "busy_ms": prof["busy_ms"], "launches_per_round": prof["launches"],
           "idle_share": 1 - prof["busy_ms"] / round_ms,
           "near_tie_bound": tie}
    if rank == 0:  # the same model on one device, dense kernels
        ref = serve_cluster.make_requests(
            cfg.vocab_size, spec["n_requests"], GEN.prompt_len,
            GEN.new_tokens, SEED)
        serve_cluster.serve(dense, params, ref, n_slots=GEN.n_slots,
                            max_len=GEN.max_len, seed=SEED)
        out["parted"] = parted_at_near_ties(
            engine, params, [r.prompt for r in reqs],
            [r.generated for r in ref], res["streams"], tie)
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))


def run_ranks(dev, seq_info) -> dict:
    """Phase (h): ``RANK_RUNS``, each as spawned processes sharing the card
    (gloo); the streams bit-identical on every rank and, at near-ties, equal
    to one device's. Returns each run's per-rank launch counts, summed."""
    torch.cuda.empty_cache()
    paths = {}
    for name, ranks, layers, n_req in RANK_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"layers": layers, "n_requests": n_req, "out": tmp,
                    "tie": seq_info["tie"]}
            spec_path = Path(tmp, "spec.json")
            spec_path.write_text(json.dumps(spec))
            t0 = time.perf_counter()
            done = spawn_ranks([str(ROOT / "chip_smoke.py"), "--rank-worker",
                                str(spec_path)], ranks,
                               store_path=str(Path(tmp, "store")),
                               timeout=RANK_TIMEOUT_S, cwd=str(ROOT))
            wall = time.perf_counter() - t0
            for r, p in enumerate(done):
                if p.returncode:
                    raise AssertionError(
                        f"{name}: rank {r} exited {p.returncode}:\n"
                        f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
            res = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                   for r in range(ranks)]
        backends = {line for p in done for line in p.stdout.splitlines()
                    if "process group backend" in line}
        if any(x["streams"] != res[0]["streams"] for x in res):
            raise AssertionError(f"{name}: the ranks' streams differ")
        counts = {k: sum(x["launches"][k] for x in res)
                  for k in res[0]["launches"]}
        summary = {k: v for k, v in res[0].items() if k != "streams"}
        summary.update(ranks_wall_s=wall, all_reduce_share=(
            res[0]["all_reduce_ms_per_round"] / res[0]["timed_round_ms"]),
            per_rank_round_ms=[x["round_ms"] for x in res],
            per_rank_all_reduce_ms=[x["all_reduce_ms_per_round"]
                                    for x in res],
            launches_all_ranks=counts)
        print(f"(h) {name}: {sorted(backends)}; streams bit-identical on "
              f"{ranks} ranks, {res[0]['parted']} of {n_req} parted from "
              f"one device at "
              f"near-ties; {json.dumps(summary)}")
        paths[name] = counts
    return paths


# ---------------------------------------------------------------------------
# Phase (i): the paper's Fig. 2 on the port's simulator, compute measured
# ---------------------------------------------------------------------------

# measure_real_per_item: one warm call, then 2048 items in batches of 32
# (64 timed calls), seven times; the per-item time is the median. The
# classify loop is host-bound, and the shared host's slow spells move
# whole measurements by up to 2x in either direction, so the spread is
# printed, not gated: the gate is that the claims come out the same at
# the fastest, the median and the slowest measurement
FIG2_ITEMS, FIG2_BATCH, FIG2_REPEATS = 2048, 32, 7
FIG2_PROFILED = 10             # classify calls in the device-busy window


def fig2_table(rs) -> str:
    return "\n".join(
        f"    bs {r['batch_size']:>4}: mono {r['mono_time_min']!r} min "
        f"${r['mono_cost_usd']!r} | par {r['par_time_min']!r} min "
        f"${r['par_cost_usd']!r} {r['par_functions']} fns | reduction "
        f"{r['reduction_pct']!r}%" for r in rs)


def classify_busy(dev) -> dict:
    """Device time of FIG2_PROFILED classify calls of FIG2_BATCH items on
    a full-width distilbert-imdb engine built as ``measure_real_per_item``
    builds it, against their host-clock window."""
    cfg = configs.get("distilbert-imdb")
    model = build_model(cfg)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    params = engine.place_params(
        model.init(torch.Generator().manual_seed(0), dev))
    tokens, _ = imdb_reviews(n=FIG2_BATCH, seq_len=128,
                             vocab=cfg.vocab_size)
    engine.classify(params, tokens)
    prof = profile_round(lambda: engine.classify(params, tokens),
                         n_prof=FIG2_PROFILED, names=("flash_fwd",))
    return {"busy_ms": prof["busy_ms"], "window_ms": prof["window_ms"],
            "flash_ms": prof["by_name"]["flash_fwd"]}


def run_fig2(dev) -> dict:
    """Phase (i): ``measure_real_per_item`` on full-width distilbert-imdb
    (flash kernel, launch count held) FIG2_REPEATS times; the
    paper-constant sweep over ``PAPER_BATCH_SIZES`` (every claim must
    pass), and the same sweep at the median, the fastest and the slowest
    measured per-item time, whose claims must agree with one another (the
    verdicts themselves are printed, not gated). Returns the launch counts
    of the measurements."""
    cfg = configs.get("distilbert-imdb")
    torch.cuda.synchronize()
    reset_counts()
    times = [fig2.measure_real_per_item(n_items=FIG2_ITEMS,
                                        batch=FIG2_BATCH, device=dev)
             for _ in range(FIG2_REPEATS)]
    torch.cuda.synchronize()
    counts = read_counts()
    n_calls = 1 + math.ceil(FIG2_ITEMS / FIG2_BATCH)
    want = dict(NO_LAUNCHES,
                flash_attention=cfg.n_layers * n_calls * FIG2_REPEATS)
    if counts != want:
        raise AssertionError(f"fig2 launches {counts}, want {want}")
    if not all(math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"fig2 per-item times {times}")
    ranked = sorted(times)
    per_item = float(np.median(times))
    print(f"(i) measured per item: {times!r} s, median {per_item!r}, "
          f"slowest / fastest {ranked[-1] / ranked[0]!r} (distilbert-imdb "
          f"full width, {FIG2_ITEMS} items in batches of {FIG2_BATCH}, seq "
          f"128, {n_calls} classify calls a measurement, "
          f"{counts['flash_attention']} flash launches; {card_line()})")
    busy = classify_busy(dev)
    print(f"(i) {FIG2_PROFILED} classify calls of {FIG2_BATCH} under the "
          f"profiler: device busy {busy['busy_ms']!r} ms a call (flash "
          f"{busy['flash_ms']!r}) in a {busy['window_ms']!r} ms window, "
          f"idle share {1 - busy['busy_ms'] / busy['window_ms']!r} "
          f"({card_line()})")
    cs = CaseStudyConfig()
    paper = fig2.rows(cs)
    checks = fig2.validate(paper)
    print(f"(i) Fig. 2 sweep, the paper's constants (per_item_s "
          f"{cs.per_item_s}):\n{fig2_table(paper)}\n    claims: "
          f"{json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"paper-constant claims fail: {checks}")
    measured = fig2.rows(dataclasses.replace(cs, per_item_s=per_item))
    mchecks = fig2.validate(measured)
    print(f"(i) Fig. 2 sweep at the card's per_item_s {per_item!r} (not "
          f"gated; {card_line()}):\n{fig2_table(measured)}\n    claims: "
          f"{json.dumps(mchecks)}")
    for label, t in (("fastest", ranked[0]), ("slowest", ranked[-1])):
        other = fig2.validate(fig2.rows(dataclasses.replace(
            cs, per_item_s=t)))
        print(f"(i) the claims at the {label} per_item_s {t!r}: "
              f"{json.dumps(other)}")
        if other != mchecks:
            raise AssertionError(
                f"the claims at the {label} per-item time differ from "
                f"those at the median: the verdict rests on the host's "
                f"noise")
    return {"counts": counts, "per_item_s": per_item,
            "claims_measured": mchecks}


# ---------------------------------------------------------------------------
# Phases (j)-(m): the control plane at full width (router, calibration,
# HTTP front door) through launch.serve's entry points, and its command
# line
# ---------------------------------------------------------------------------

# (j): prompts of 64 tokens, 16 new, 8 slots a replica, at most 4
# replicas, bursty arrivals at 12 rps over 4 s, 0.02 s a token modeled;
# no ArtifactStore: the 15.2 GB params are not pickled into one
ROUTER = dict(traffic="bursty", rate=12.0, horizon=4.0, prompt_len=64,
              max_new_tokens=16, n_slots=8, max_replicas=4, seed=SEED,
              store=False)
ROUTER_CRASH_PROB = 0.1
# (k): decode rounds at 1-8 slots, each the mean of CAL_STEPS calls, and
# prefills of 64 and 128 tokens, the fastest of CAL_REPEATS samples a
# shape; the fit must explain them to within CAL_RMSE_FRAC of its overhead.
# CAL_STEPS was 64 until phase (r) took the script to 1 200 s of its
# 1 200 s limit on a slow host (the samples took most of (k)'s 107 s)
CAL_SLOTS, CAL_STEPS, CAL_REPEATS, CAL_RMSE_FRAC = (1, 2, 4, 8), 16, 5, 0.2
HTTP_CLIENTS = 24              # (l): three replicas' slots
HTTP_TIMEOUT_S = 300.0
# (m): the command line at main()'s smoke config: clients of --http, and
# how long it serves them
CLI_HTTP_CLIENTS, CLI_SERVE_S = 6, 10.0


# the engine's admission calls (dense and paged, greedy and fused), each of
# which prefills one request
ADMISSIONS = ("prefill_into", "prefill_into_sample", "extend_row",
              "extend_row_sample")


class _CallSpy:
    """Counts the calls of ``names`` on ``target`` (an engine or a module)
    inside the block: ``by_name`` per name, ``calls`` in all. With
    ``keep``, ``log`` holds each call's (arguments, result, host
    seconds), or, where ``keep`` is a function, what ``keep(name,
    arguments, result)`` returns."""

    def __init__(self, target, names=ADMISSIONS, keep=False):
        self.target, self.names, self.keep = target, names, keep
        self.calls, self.log = 0, []
        self.by_name = dict.fromkeys(names, 0)

    def __enter__(self):
        own = vars(self.target)
        self.saved = {name: own.get(name) for name in self.names}
        for name in self.names:
            fn = getattr(self.target, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls += 1
                self.by_name[_name] += 1
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if callable(self.keep):
                    self.log.append(self.keep(_name, a, out))
                elif self.keep:
                    self.log.append((a, out, time.perf_counter() - t0))
                return out
            setattr(self.target, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            if fn is None:          # a method of the target's class
                delattr(self.target, name)
            else:
                setattr(self.target, name, fn)


def routed(engine, params, cfg, label, tag="(j)", **kw) -> dict:
    """One ``launch.serve.run_router`` call with the launch counts set to
    0 just before and read just after; checks that every request of every
    policy's run completed, one decode call a round, and that no replica
    made a shape bucket the engine did not already have."""
    buckets = engine.compile_count
    torch.cuda.synchronize()
    reset_counts()
    with _CallSpy(engine) as spy:
        runs = serve.run_router(cfg, engine=engine, params=params,
                                **dict(ROUTER, **kw))
    torch.cuda.synchronize()
    counts = read_counts()
    replicas = [r for run in runs.values()
                for r in run["router"].pool.replicas]
    for name, run in runs.items():
        rep = run["report"]
        if rep.n_completed != rep.n_submitted or rep.n_rejected \
                or rep.n_expired:
            raise AssertionError(f"{label} / {name}: {rep.summary()}")
    for r in replicas:
        if r.batcher.decode_dispatches != r.batcher.rounds:
            raise AssertionError(f"{label}: replica {r.replica_id} made "
                                 f"{r.batcher.decode_dispatches} decode "
                                 f"calls in {r.batcher.rounds} rounds")
    new_buckets = engine.compile_count - buckets
    if new_buckets:
        raise AssertionError(f"{label}: {new_buckets} new shape buckets "
                             f"over {len(replicas)} replicas")
    out = {"label": label, "runs": runs, "counts": counts,
           "admissions": spy.calls, "replicas": len(replicas),
           "decode_dispatches": sum(r.batcher.decode_dispatches
                                    for r in replicas)}
    for name, run in runs.items():
        s = run["summary"]
        print(f"{tag} {label:<22} {name:<11} {s['n_completed']}/"
              f"{s['n_submitted']} done, TTFT p50 {s['ttft_p50_s']} p99 "
              f"{s['ttft_p99_s']} s, TPOT p50 {s['tpot_p50_s']} s, peak "
              f"{s['peak_replicas']} ({len(run['router'].pool.replicas)} "
              f"spawned), crashes {s['n_crashes']}, busy "
              f"{s['busy_replica_s']} s, ${s['cost_usd']} "
              f"[{s['time_model']}]")
    print(f"{tag} {label}: launches {json.dumps(counts)}, {spy.calls} "
          f"admissions, {out['decode_dispatches']} decode calls, "
          f"{len(replicas)} replicas")
    return out


def router_requests(cfg):
    """Phase (j)'s requests: ROUTER's traffic, prompts and new tokens,
    drawn as ``launch.serve.run_router`` draws them."""
    arrivals = TRAFFIC[ROUTER["traffic"]](ROUTER["rate"], ROUTER["horizon"],
                                         SEED)
    return make_requests(arrivals, prompt_len=ROUTER["prompt_len"],
                         max_new_tokens=ROUTER["max_new_tokens"],
                         vocab=cfg.vocab_size, seed=SEED)


def batcher_streams(engine, params, reqs, **kw) -> dict:
    """The requests served by one ContinuousBatcher on the engine, at the
    replicas' slots and cache length; their streams by rid."""
    res = serve_cluster.serve(engine, params, reqs, n_slots=ROUTER["n_slots"],
                              max_len=ROUTER["prompt_len"]
                              + ROUTER["max_new_tokens"] + 8, **kw)
    if len(res["completed"]) != len(reqs):
        raise AssertionError("the single batcher did not finish")
    return {r.rid: list(r.generated) for r in reqs}


def hold_streams(engine, params, label, reqs, got: dict, want: dict) -> int:
    """Greedy streams ``got`` against ``want``, by rid: equal, or parted
    at a near-tie (phase (f)'s rule at its floor: both tokens within
    LOGIT_FLOOR of the best logit), in at most a third of them."""
    rids = sorted(want)
    if sorted(got) != rids:
        raise AssertionError(f"{label}: rids {sorted(got)} vs {rids}")
    by_rid = {r.rid: r for r in reqs}
    parted = parted_at_near_ties(engine, params,
                                 [by_rid[i].prompt for i in rids],
                                 [want[i] for i in rids],
                                 [got[i] for i in rids], LOGIT_FLOOR)
    if parted > len(rids) // 3:
        raise AssertionError(f"{label}: {parted} of {len(rids)} parted")
    return parted


def control_plane_model(dev):
    """Full-width qwen2-7b, random weights from SEED, tamed q/k, behind
    ``launch.serve.lm_engine`` (the hand kernels, cache_pad 16)."""
    cfg = configs.get("qwen2-7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    tame_attention(cfg, params)
    engine, params = serve.lm_engine(cfg, device=dev, params=params)
    return cfg, engine, params


def run_router_phase(dev, lm) -> dict:
    """Phase (j): ``launch.serve.run_router`` on the full-width model: the
    four default policies greedy and dense, queue depth under crashes,
    paged, fused sampled and on measured time. Returns the launch counts
    of its runs, summed, and the requests with their greedy streams."""
    cfg, engine, params = lm

    def requests():
        return router_requests(cfg)

    # the same requests through one batcher, dense and paged (this also
    # makes every greedy bucket, so no replica may make one); the fused
    # sampled buckets likewise, before their routed runs
    reqs = requests()
    want = batcher_streams(engine, params, reqs)
    want_paged = batcher_streams(engine, params, requests(), paged=True)
    batcher_streams(engine, params, requests(), fused_sampling=True,
                    **serve_cluster.SAMPLING)

    one = [QueueDepthPolicy(max_replicas=ROUTER["max_replicas"])]
    default = routed(engine, params, cfg, "greedy dense")
    crash = routed(engine, params, cfg, "greedy dense, crashes",
                   policies=one, crash_prob=ROUTER_CRASH_PROB)
    paged = routed(engine, params, cfg, "greedy paged", policies=one,
                   paged=True)
    fused = routed(engine, params, cfg, "fused sampled", policies=one,
                   fused_sampling=True, sampling=serve_cluster.SAMPLING)
    measured = routed(engine, params, cfg, "greedy dense, measured",
                      policies=one, measured_time=True)
    calls = [default, crash, paged, fused, measured]

    n_layers, parted = cfg.n_layers, {}
    for call in (default, crash, measured):
        want_c = dict(NO_LAUNCHES,
                      flash_attention=n_layers * call["admissions"],
                      decode_attention=n_layers * call["decode_dispatches"])
        if call["counts"] != want_c:
            raise AssertionError(f"{call['label']}: launches "
                                 f"{call['counts']}, want {want_c}")
    if paged["counts"]["paged_decode_attention"] != \
            n_layers * paged["decode_dispatches"]:
        raise AssertionError(f"paged launches {paged['counts']}")
    n_sampled = fused["admissions"] + fused["decode_dispatches"]
    if not fused["counts"]["fused_sample"] or \
            fused["counts"]["fused_sample"] != n_sampled:
        raise AssertionError(f"fused launches {fused['counts']}, want "
                             f"{n_sampled} sampling launches")
    for call, ref in ((default, want), (crash, want), (paged, want_paged),
                      (measured, want)):
        for name, run in call["runs"].items():
            got = {r.rid: list(r.generated) for r in run["router"].completed}
            parted[f"{call['label']} / {name}"] = hold_streams(
                engine, params, call["label"], reqs, got, ref)
    print(f"(j) greedy streams vs one ContinuousBatcher (dense, or paged "
          f"for the paged run) on the same {len(want)} requests, parted at "
          f"near-ties: {json.dumps(parted)};"
          f" no replica made a shape bucket (engine buckets "
          f"{engine.compile_count})")

    fixed = default["runs"]["fixed-1"]["report"]
    auto = default["runs"]["queue-depth"]["report"]
    p99_f = float(np.percentile(fixed.ttft_s, 99))
    p99_a = float(np.percentile(auto.ttft_s, 99))
    if not (p99_a < p99_f
            and abs(auto.busy_replica_s - fixed.busy_replica_s)
            <= 1e-9 * fixed.busy_replica_s
            and auto.cost_usd <= fixed.cost_usd * (1 + 1e-6)):
        raise AssertionError(f"queue-depth p99 TTFT {p99_a} vs fixed-1 "
                             f"{p99_f}, busy {auto.busy_replica_s} vs "
                             f"{fixed.busy_replica_s}")
    print(f"(j) queue-depth beats fixed-1 on p99 TTFT: {p99_a} s vs "
          f"{p99_f} s at equal modeled busy seconds "
          f"({auto.busy_replica_s})")
    m = measured["runs"]["queue-depth"]["summary"]
    print(f"(j) measured time on {card_line()}: TTFT p50 "
          f"{m['ttft_p50_s']} p99 {m['ttft_p99_s']} s, TPOT p50 "
          f"{m['tpot_p50_s']} s, peak {m['peak_replicas']} replicas, busy "
          f"{m['busy_replica_s']} s, ${m['cost_usd']}")
    counts = dict(NO_LAUNCHES)
    for call in calls:
        for k, v in call["counts"].items():
            counts[k] += v
    return {"counts": counts, "summaries": {
        f"{c['label']} / {name}": run["summary"]
        for c in calls for name, run in c["runs"].items()}}


def run_calibration(dev, lm) -> dict:
    """Phase (k): ``launch.serve.calibrate`` on the full-width engine
    (decode rounds at CAL_SLOTS, prefills of 64 and 128 tokens), the
    artifact saved under build/ and loaded back, then one router pass on
    the calibrated clock. Returns its launch counts."""
    cfg, engine, params = lm
    path = ROOT / "build" / "calibration_qwen2_7b.json"
    path.parent.mkdir(exist_ok=True)
    cal = serve.calibrate(engine, params, prompt_len=ROUTER["prompt_len"],
                          max_new_tokens=ROUTER["max_new_tokens"],
                          slot_counts=CAL_SLOTS, n_steps=CAL_STEPS,
                          repeats=CAL_REPEATS, path=str(path),
                          source="chip_smoke.py phase (k)")
    back = CalibratedLatencyModel.load(str(path))
    if back != cal or cal.backend != "cuda" or \
            cal.n_samples != len(CAL_SLOTS) + 2:
        raise AssertionError(f"calibration artifact {back} vs {cal}")
    if not cal.rmse_s <= CAL_RMSE_FRAC * cal.round_overhead_s:
        raise AssertionError(f"the round model does not fit the card's "
                             f"rounds: {cal}")
    print(f"(k) fitted on {card_line()}: round_overhead_s "
          f"{cal.round_overhead_s!r}, per_item_s {cal.per_item_s!r}, "
          f"prefill_token_factor {cal.prefill_token_factor!r}, rmse_s "
          f"{cal.rmse_s!r}, max_abs_err_s {cal.max_abs_err_s!r}, "
          f"{cal.n_samples} samples")
    batcher_streams(engine, params, router_requests(cfg))  # the buckets
    call = routed(engine, params, cfg, "calibrated", tag="(k)",
                  policies=[QueueDepthPolicy(
                      max_replicas=ROUTER["max_replicas"])],
                  calibration=back)
    (run,) = call["runs"].values()
    if run["report"].time_model != "calibrated":
        raise AssertionError(run["summary"])
    return {"counts": call["counts"], "calibration": cal.to_json(),
            "summary": run["summary"]}


async def http_generate(port: int, prompt, n_new: int) -> list:
    """One streaming client: POST /v1/generate, read the NDJSON chunks."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": n_new})
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    await writer.drain()
    status = await reader.readline()
    if b"200" not in status:
        raise AssertionError(f"generate: {status!r}")
    while (await reader.readline()) not in (b"\r\n", b"\n"):
        pass
    chunks = []
    while True:
        size = int((await reader.readline()).strip() or b"0", 16)
        if size == 0:
            break
        chunks.append(json.loads(await reader.readexactly(size)))
        await reader.readexactly(2)          # chunk trailer CRLF
    writer.close()
    return chunks


async def http_get(port: int, path: str) -> tuple:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while (h := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    body = await reader.readexactly(int(headers["content-length"]))
    writer.close()
    return status, body.decode()


def run_http_phase(dev, lm) -> dict:
    """Phase (l): ``launch.serve.run_http`` on 127.0.0.1 (port 0, wall
    clock, trace into build/): HTTP_CLIENTS concurrent clients with
    phase (j)'s prompt and new-token lengths, more than one replica
    holds, so the wall-clock policy must scale up; their streams against
    a virtual-clock EventRouter on the same requests, /metrics linted,
    /healthz, the trace rendered by trace_report. Every read has a
    timeout, and a serve loop that raises fails the phase with its error.
    Returns its launch counts."""
    cfg, engine, params = lm
    n_new = ROUTER["max_new_tokens"]
    reqs = make_requests(np.zeros(HTTP_CLIENTS),
                         prompt_len=ROUTER["prompt_len"],
                         max_new_tokens=n_new, vocab=cfg.vocab_size,
                         seed=SEED)
    trace_path = ROOT / "build" / "trace_http.jsonl"
    trace_path.parent.mkdir(exist_ok=True)

    async def clients(port):
        streams = await asyncio.wait_for(asyncio.gather(
            *(http_generate(port, r.prompt, n_new) for r in reqs)),
            HTTP_TIMEOUT_S)
        metrics = await asyncio.wait_for(http_get(port, "/metrics"), 60)
        health = await asyncio.wait_for(http_get(port, "/healthz"), 60)
        return streams, metrics, health

    torch.cuda.synchronize()
    reset_counts()
    out = serve.run_http(cfg, engine=engine, params=params, seed=SEED,
                         port=0, trace=str(trace_path), clients=clients,
                         prompt_len=ROUTER["prompt_len"],
                         max_new_tokens=n_new, n_slots=ROUTER["n_slots"],
                         max_replicas=ROUTER["max_replicas"])
    torch.cuda.synchronize()
    counts = read_counts()
    router, (streams, metrics, health) = out["router"], out["clients"]
    got = {}
    for r, chunks in zip(reqs, streams):
        toks, end = chunks[:-1], chunks[-1]
        if (end.get("event") != "end" or not end["done"]
                or len(toks) != n_new):
            raise AssertionError(f"client {r.rid}: {chunks[-2:]}")
        got[r.rid] = [c["token"] for c in toks]
    lint = lint_prometheus(metrics[1])
    if metrics[0] != 200 or lint:
        raise AssertionError(f"/metrics: {metrics[0]} {lint[:5]}")
    health = json.loads(health[1])
    if not (health["ok"] and health["ready"]):
        raise AssertionError(f"/healthz: {health}")
    n_admitted = int(router.obs.m_admitted.value())
    n_decode = sum(r.batcher.decode_dispatches for r in router.pool.replicas)
    want_c = dict(NO_LAUNCHES, flash_attention=cfg.n_layers * n_admitted,
                  decode_attention=cfg.n_layers * n_decode)
    if counts != want_c:
        raise AssertionError(f"http launches {counts}, want {want_c}")

    # the same requests on the virtual clock, through the same engine
    virt = EventRouter(
        ReplicaPool(engine, params, serve.replica_config(
            n_slots=ROUTER["n_slots"], prompt_len=ROUTER["prompt_len"],
            max_new_tokens=n_new), lat=LatencyModel(per_item_s=0.02)),
        QueueDepthPolicy(max_replicas=ROUTER["max_replicas"]),
        [Request(r.rid, r.prompt, n_new, arrival_t=0.0) for r in reqs],
        traffic_name="virtual")
    virt.run_events()
    want = {r.rid: list(r.generated) for r in virt.completed}
    parted = hold_streams(engine, params, "http", reqs, got, want)

    trace = trace_report.load(str(trace_path))
    text = trace_report.report(trace)
    lines = text.splitlines()
    if not lines[-1].endswith(f"{len(reqs)} requests"):
        raise AssertionError(f"trace report: {lines[-1]}")
    rep = out["report"]
    if rep["peak_replicas"] < 2:
        raise AssertionError(f"{len(reqs)} clients on {ROUTER['n_slots']} "
                             f"slots a replica did not scale up: {rep}")
    print("(l) trace_report of the HTTP run:\n" + "\n".join(
        "    " + line for line in lines[:3] + ["..."] + lines[-9:]))
    print(f"(l) HTTP front door, {len(reqs)} concurrent clients, wall "
          f"clock on {card_line()}: TTFT p50 {rep['ttft_p50_s']} p99 "
          f"{rep['ttft_p99_s']} s, TPOT p50 {rep['tpot_p50_s']} s, peak "
          f"{rep['peak_replicas']} replicas, busy {rep['busy_replica_s']} "
          f"s; streams vs the virtual-clock EventRouter: {parted} of "
          f"{len(reqs)} parted at near-ties; /metrics lints clean "
          f"({len(metrics[1].splitlines())} lines), /healthz {health}; "
          f"trace {len(trace)} events -> {trace_path.relative_to(ROOT)}; "
          f"launches {json.dumps(counts)}")
    return {"counts": counts, "summary": rep}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_mode(label, argv, counts: dict):
    """One ``launch.serve.main(argv)`` with the launch counts set to 0
    just before and read just after into ``counts[label]``; the flash and
    decode kernels must have run."""
    torch.cuda.synchronize()
    reset_counts()
    out = serve.main(argv)
    torch.cuda.synchronize()
    counts[label] = read_counts()
    if not (counts[label]["flash_attention"]
            and counts[label]["decode_attention"]):
        raise AssertionError(f"{label}: launches {counts[label]}")
    return out


def run_cli(dev) -> dict:
    """Phase (m): ``launch.serve.main`` as a user runs it, with no
    ``--device`` (so on the card) at the smoke config ``main`` serves:
    ``--router`` (every default policy), ``--calibrate`` (the artifact
    under build/) and ``--http``, which serves CLI_SERVE_S seconds from a
    thread while CLI_HTTP_CLIENTS clients here POST to it. Returns the
    launch counts of the three."""
    counts = {}
    runs = cli_mode("--router", ["--router", "--horizon", "2"], counts)
    for name, s in runs.items():
        if s["n_completed"] != s["n_submitted"] or not s["n_submitted"]:
            raise AssertionError(f"--router / {name}: {s}")
    cal_path = ROOT / "build" / "calibration_cli.json"
    out = cli_mode("--calibrate", ["--calibrate", "--calibration",
                                   str(cal_path)], counts)
    cal = CalibratedLatencyModel.load(str(cal_path))
    if out["calibration"] != cal.to_json() or cal.backend != "cuda":
        raise AssertionError(f"--calibrate: {cal}")

    port, box = free_port(), {}
    trace_path = ROOT / "build" / "trace_cli.jsonl"
    argv = ["--http", "--port", str(port), "--serve-seconds",
            str(CLI_SERVE_S), "--trace", str(trace_path)]

    def serve_http():
        try:
            box["out"] = cli_mode("--http", argv, counts)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["error"] = e

    async def clients():
        deadline = time.monotonic() + CLI_SERVE_S
        while True:
            try:
                await asyncio.wait_for(http_get(port, "/healthz"), 5)
                break
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    raise
                await asyncio.sleep(0.1)
        return await asyncio.wait_for(asyncio.gather(
            *(http_generate(port, [1 + i] * 16, 8)
              for i in range(CLI_HTTP_CLIENTS))), CLI_SERVE_S)

    server = threading.Thread(target=serve_http)
    server.start()
    try:
        streams = asyncio.run(clients())
    finally:
        server.join(HTTP_TIMEOUT_S)
    if server.is_alive():
        raise AssertionError("--http still serving")
    if "error" in box:
        raise box["error"]
    rep = box["out"]["report"]
    if rep["n_completed"] != CLI_HTTP_CLIENTS or any(
            len(c) != 9 or not c[-1]["done"] for c in streams):
        raise AssertionError(f"--http: {rep}")
    for label, c in counts.items():
        print(f"(m) launch.serve {label} on {card_line()}: launches "
              f"{json.dumps(c)}")
    print(f"(m) --http: {CLI_HTTP_CLIENTS} clients, TTFT p50 "
          f"{rep['ttft_p50_s']} s, TPOT p50 {rep['tpot_p50_s']} s; "
          f"--calibrate: {cal.summary()}")
    return {f"cli_{label.lstrip('-')}": c for label, c in counts.items()}


# ---------------------------------------------------------------------------
# Phase (n): the batch DAG on the full-width qwen2-7b
# ---------------------------------------------------------------------------

# the reference CLI's defaults (48 items, shards of 8, 6 workers, 4 slots a
# replica, 8 new tokens) with the router phases' 64-token prompts
DAG = dict(dag_items=48, dag_shard_size=8, dag_workers=6, n_slots=4,
           prompt_len=64, max_new_tokens=8, seed=SEED)
# the spot mix (4 of the 6 workers spot) and all-spot, each at a rate whose
# kills land on busy workers on this clock, which is the same on any
# device: the spot mix's seed lands one at 0.75/s and none at 0.25, 0.5 or
# 1.0/s; all-spot lands two at 1.0/s
DAG_SPOT, DAG_SPOT_RATE = 4, 0.75
DAG_ALL_SPOT_RATE = 1.0
# qwen2-7b's widths at DAG_LAYERS of its 28 layers: the phase ran 150-168 s
# at 28 and the script, with phase (u), past its 1 200 s limit on a slow
# host (PERF.md §6); every digest, stage and kill is the same at any
# depth
DAG_LAYERS = 8
# the calibrated pair's clock: decode rounds at 1-4 slots (each the mean
# of DAG_CAL_STEPS calls) and prefills of 64 and 128 tokens, the fastest
# of DAG_CAL_REPEATS samples a shape
DAG_CAL_SLOTS, DAG_CAL_STEPS, DAG_CAL_REPEATS = (1, 2, 4), 8, 2


def dag_line(label: str, rep, host_s: float) -> str:
    return (f"{label:<16} host {host_s:.3f} s | modeled wall "
            f"{rep.wall_s!r} s, busy {rep.busy_s!r} s, cost "
            f"${rep.cost_usd!r} | {rep.n_tasks} tasks, attempts "
            f"{rep.attempts_total}, preemptions {rep.n_preemptions}, spawns "
            f"{rep.n_spawns}, dup commits {rep.n_duplicate_commits}, "
            f"compiles {rep.compile_count}, digest {rep.digest[:16]}")


def run_batch_dag_phase(dev) -> dict:
    """Phase (n): ``launch.serve.run_batch_dag`` on the full-width
    qwen2-7b (random weights from SEED, the reference's init) with the
    engine handed in: monolithic, parallel and the chaos ladder on
    on-demand pools, then a spot mix and all-spot under live preemptions,
    each held to the monolithic digest; the reduce output against one
    batcher's greedy streams; launch counts against the engine's calls;
    each run's host seconds (timed around ``launch.serve.run_dag``); round
    times; and the mono/parallel pair again on a clock calibrated from
    this engine's own rounds (printed, not gated). Returns the DAG path's
    launch counts."""
    cfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=DAG_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    engine, params = serve.lm_engine(cfg, device=dev, params=params,
                                     cache_pad=8)
    rcfg = ReplicaConfig(
        n_slots=DAG["n_slots"],
        max_len=DAG["prompt_len"] + DAG["max_new_tokens"])
    torch.cuda.synchronize()
    reset_counts()
    with _CallSpy(engine, ("prefill", "prefill_into", "decode")) as spy, \
            _CallSpy(serve, ("run_dag",), keep=True) as dag_runs:
        out = serve.run_batch_dag(cfg, engine=engine, params=params,
                                  chaos=True, **DAG)
        data = dag_runs.log[0][0][0]
        for spot, rate in ((DAG_SPOT, DAG_SPOT_RATE),
                           (DAG["dag_workers"], DAG_ALL_SPOT_RATE)):
            serve.run_dag(data, DAG["dag_shard_size"], serve.dag_groups(
                engine, params, rcfg, DAG["dag_workers"], spot_workers=spot,
                preempt_rate=rate, seed=SEED))
    torch.cuda.synchronize()
    counts = read_counts()
    calls = dict(spy.by_name)

    n_rungs = out["chaos"]["kills"] + 1
    labels = (["monolithic", "parallel"]
              + [f"chaos rung {k}" for k in range(n_rungs)]
              + ["spot mix", "all-spot"])
    if len(dag_runs.log) != len(labels):
        raise AssertionError(f"{len(dag_runs.log)} DAG runs, want "
                             f"{len(labels)}: {labels}")
    runs = {label: (rep, host_s)
            for label, (_, rep, host_s) in zip(labels, dag_runs.log)}
    mono, par = runs["monolithic"][0], runs["parallel"][0]
    ladder = [runs[f"chaos rung {k}"][0] for k in range(n_rungs)]
    print(f"(n) on {card_line()}:")
    for label, (rep, host_s) in runs.items():
        print("(n) " + dag_line(label, rep, host_s))
    print(f"(n) speedup {mono.wall_s / par.wall_s!r}, cost ratio "
          f"{par.cost_usd / mono.cost_usd!r} on the reference's modeled "
          f"clock")

    if (not out["outputs_identical"] or not out["chaos"]["parity"]
            or n_rungs != 5 or out["mono"] != mono.summary()
            or out["par"] != par.summary()):
        raise AssertionError(f"DAG: {out}")
    for k, rep in enumerate(ladder):
        if (rep.digest != mono.digest or rep.n_preemptions != k
                or rep.n_duplicate_commits
                or rep.compile_count != mono.compile_count
                or rep.n_rows != DAG["dag_items"]):
            raise AssertionError(f"chaos rung {k}: {rep.summary()}")
    for label, groups in (("spot mix", {"on-demand", "spot"}),
                          ("all-spot", {"spot"})):
        rep = runs[label][0]
        if (rep.digest != mono.digest or rep.n_duplicate_commits
                or not rep.n_preemptions
                or rep.cost_by_group.keys() != groups):
            raise AssertionError(f"{label}: {rep.summary()}")
    layers = cfg.n_layers
    want = dict(NO_LAUNCHES, flash_attention=layers * (
        calls["prefill"] + calls["prefill_into"]),
        decode_attention=layers * calls["decode"])
    if counts != want:
        raise AssertionError(f"DAG launches {counts}, want {want} from "
                             f"engine calls {calls}")

    # the reduce output against one batcher over the same prompts
    reqs = [Request(rid=i, prompt=data.tokens[i],
                    max_new_tokens=DAG["max_new_tokens"])
            for i in range(data.n_items)]
    serve_cluster.serve(engine, params, reqs, n_slots=DAG["n_slots"],
                        max_len=rcfg.max_len)
    streams = {r.rid: [int(t) for t in r.generated] for r in reqs}
    if streams != mono.outputs:
        differ = [i for i in streams if streams[i] != mono.outputs[i]]
        raise AssertionError(f"reduce output != one batcher's greedy "
                             f"streams for rows {differ}")

    # round times on CUDA events: a prefill-stage row (B = 1) and a decode
    # round of the replicas' four slots
    prompt = data.tokens[0][None]
    prefill_ms = cuda_ms(lambda: engine.prefill(params, prompt), iters=10)
    cache = engine.new_cache(DAG["n_slots"], rcfg.max_len)
    for row in range(DAG["n_slots"]):
        engine.prefill_into(params, cache, row, data.tokens[row][None])
    tok = torch.ones((DAG["n_slots"], 1), dtype=torch.int32, device=dev)

    def decode_round():
        cache.lengths.fill_(DAG["prompt_len"])
        engine.decode(params, cache, tok)
    decode_ms = cuda_ms(decode_round, iters=10)
    prof = profile_round(decode_round)

    cal = serve.calibrate(engine, params, prompt_len=DAG["prompt_len"],
                          max_new_tokens=DAG["max_new_tokens"],
                          slot_counts=DAG_CAL_SLOTS, n_steps=DAG_CAL_STEPS,
                          repeats=DAG_CAL_REPEATS, path=None,
                          source="chip_smoke.py phase (n)")
    with _CallSpy(serve, ("run_dag",), keep=True) as cal_runs:
        serve.run_dag(data, DAG["dag_items"], serve.dag_groups(
            engine, params, rcfg, 1), calibration=cal)
        serve.run_dag(data, DAG["dag_shard_size"], serve.dag_groups(
            engine, params, rcfg, DAG["dag_workers"]), calibration=cal)
    (_, cal_mono, cal_mono_s), (_, cal_par, cal_par_s) = cal_runs.log
    if cal_mono.digest != mono.digest or cal_par.digest != mono.digest:
        raise AssertionError("the calibrated runs changed the outputs")
    print("(n) " + dag_line("calibrated mono", cal_mono, cal_mono_s))
    print("(n) " + dag_line("calibrated par", cal_par, cal_par_s))
    result = {
        "engine_calls": calls, "launches": counts,
        "prefill_ms": prefill_ms, "decode_round_ms": decode_ms,
        "decode_round_busy_ms": prof["busy_ms"],
        "decode_round_idle_share": 1 - prof["busy_ms"] / decode_ms,
        "decode_round_launches": prof["launches"],
        "host_s": {label: host_s for label, (_, host_s) in runs.items()},
        "modeled": {"speedup": mono.wall_s / par.wall_s,
                    "cost_ratio": par.cost_usd / mono.cost_usd},
        "spot_preemptions": {label: runs[label][0].n_preemptions
                             for label in ("spot mix", "all-spot")},
        "calibration": cal.summary(),
        "calibrated": {"mono_wall_s": cal_mono.wall_s,
                       "par_wall_s": cal_par.wall_s,
                       "speedup": cal_mono.wall_s / cal_par.wall_s,
                       "cost_ratio": cal_par.cost_usd / cal_mono.cost_usd},
        "digest": mono.digest,
    }
    print(f"(n) one digest over mono, parallel, {len(ladder)} chaos rungs, "
          f"the spot mix and all-spot, equal to one batcher's streams; "
          + json.dumps(result))
    del engine, params, cache
    return {"counts": counts}


# ---------------------------------------------------------------------------
# Phase (o): training the full-width distilbert-imdb, then serving it
# ---------------------------------------------------------------------------

# 768 reviews to train on and 256 held out, 128 tokens, the planted signal
# of the reference's case study; AdamW, warmup then cosine to LR_FINAL
TRAIN = dict(n_train=768, n_held=256, seq_len=128, batch=32, steps=60,
             signal_frac=0.15)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 6
# labels of the flash and plain paths may differ only on items whose two
# logits lie within this of each other on either path
TRAIN_MARGIN = LOGIT_FLOOR
# and their logits must agree to phase (f)'s relative RMS between a kernel
# and a plain path
TRAIN_LOGIT_RTOL = PATH_RTOL
# one step with remat / microbatch against the plain one: the loss within
# the rtol, and at most the share of master weights off by more than lr/2
# (AdamW's first step moves every weight by about +-lr)
REMAT_RTOL, REMAT_SHARE = 1e-6, 1e-3
MICRO_RTOL, MICRO_SHARE = 1e-3, 0.02
TRAIN_MICROBATCH = 8


def distilbert_init(dev, tame: bool = True):
    """(cfg, model, params) of the full-width distilbert-imdb from SEED; with
    ``tame``, q/k at a fan-in std (:func:`tame_attention`)."""
    cfg = configs.get("distilbert-imdb")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    if tame:
        tame_attention(cfg, params)
    return cfg, model, params


def imdb_split(cfg):
    """(train tokens, train labels, held tokens, held labels)."""
    tokens, labels = imdb_reviews(
        n=TRAIN["n_train"] + TRAIN["n_held"], seq_len=TRAIN["seq_len"],
        vocab=cfg.vocab_size, seed=SEED, signal_frac=TRAIN["signal_frac"])
    n = TRAIN["n_train"]
    return tokens[:n], labels[:n], tokens[n:], labels[n:]


def adamw():
    return optimizer.AdamW(schedule=optimizer.warmup_cosine(
        TRAIN_LR, TRAIN_WARMUP, TRAIN["steps"]), weight_decay=0.0)


def train_classifier(model, params, tokens, labels, steps) -> tuple:
    """``steps`` AdamW steps on batches of TRAIN["batch"]; returns the
    params, the losses and each step's ms on CUDA events."""
    opt = adamw()
    state = opt.init(params)
    step = train_step.make_train_step(model, RunConfig(), opt)
    loader = TrainLoader(tokens, labels, batch=TRAIN["batch"], seed=SEED)
    events, losses = [], []
    for _ in range(steps):
        batch = loader.next_batch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, batch)
        end.record()
        events.append((start, end))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return (params, [float(x) for x in losses],
            [s.elapsed_time(e) for s, e in events])


def share_off(a, b, tol) -> float:
    off = tot = 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs()
        off += int((d > tol).sum())
        tot += d.numel()
    return off / tot


def check_step_variants(model, params, batch) -> dict:
    """One step each with remat "full", "dots" and microbatching against
    the plain step, from the same params and batch."""
    opt = adamw()

    def one(run):
        return train_step.make_train_step(model, run, opt)(
            params, opt.init(params), batch)
    _, plain, pm = one(RunConfig())
    lr = float(pm["lr"])
    out = {}
    for name, run, rtol, share_max in (
            ("remat_full", RunConfig(remat="full"), REMAT_RTOL, REMAT_SHARE),
            ("remat_dots", RunConfig(remat="dots"), REMAT_RTOL, REMAT_SHARE),
            (f"microbatch_{TRAIN_MICROBATCH}",
             RunConfig(microbatch=TRAIN_MICROBATCH), MICRO_RTOL,
             MICRO_SHARE)):
        _, got, m = one(run)
        share = share_off(got["master"], plain["master"], lr / 2)
        bit_equal = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(got["master"]), tree_leaves(plain["master"])))
        rel = abs(float(m["loss"]) - float(pm["loss"])) / float(pm["loss"])
        out[name] = {"loss_rel_diff": rel, "share_off": share,
                     "bit_equal": bit_equal}
        if rel > rtol or share > share_max:
            raise AssertionError(f"{name} vs the plain step: {out[name]} "
                                 f"(loss rtol {rtol}, share {share_max})")
    return out


def near_tie_labels(a, b, margin) -> tuple:
    """(items whose logits lie within ``margin`` on either path, label
    disagreements outside them)."""
    near = (np.abs(a[:, 0] - a[:, 1]) < margin) | (
        np.abs(b[:, 0] - b[:, 1]) < margin)
    differ = a.argmax(-1) != b.argmax(-1)
    return int(near.sum()), [int(i) for i in np.flatnonzero(differ & ~near)]


def run_training_phase(dev) -> dict:
    """Phase (o): train the full-width distilbert-imdb (q/k at a fan-in
    std; the reference's init memorizes, which this phase also shows),
    check remat and microbatching, classify the held-out set through the
    flash kernel and the plain path, run phase (b)'s offline job and the
    case-study example on the card. Returns the serving paths' launch
    counts."""
    cfg, model, init = distilbert_init(dev)
    x, y, held_x, held_y = imdb_split(cfg)
    torch.cuda.reset_peak_memory_stats()
    with train_launch.deterministic():
        first = {"tokens": x[:TRAIN["batch"]], "labels": y[:TRAIN["batch"]]}
        variants = check_step_variants(model, init, first)
        params, losses, step_ms = train_classifier(model, init, x, y,
                                                   TRAIN["steps"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        before = fa_ops.launches
        try:
            train_step.make_train_step(model, RunConfig(attn_impl="pallas"),
                                       adamw())(init, adamw().init(init),
                                                first)
            raise AssertionError("a training step under the flash kernel "
                                 "did not raise")
        except NotImplementedError:
            pass
        if fa_ops.launches != before:
            raise AssertionError("the flash kernel ran under autograd")
        # the same run from the reference's init, for the record
        _, ref_model, ref_init = distilbert_init(dev, tame=False)
        ref_params, ref_losses, _ = train_classifier(
            ref_model, ref_init, x, y, TRAIN["steps"])
    median_ms = float(np.median(step_ms))
    tok_s = TRAIN["batch"] * TRAIN["seq_len"] / (median_ms / 1e3)

    kernel = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    plain = Engine(model, RunConfig(attn_impl="xla"), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    k_logits = kernel.classify_logits(params, held_x)
    torch.cuda.synchronize()
    counts = read_counts()
    p_logits = plain.classify_logits(params, held_x)
    ref_acc = float((plain.classify(ref_params, held_x) == held_y).mean())
    acc = float((k_logits.argmax(-1) == held_y).mean())
    near, hard = near_tie_labels(k_logits, p_logits, TRAIN_MARGIN)
    logit_rms = rel_rms(torch.from_numpy(k_logits),
                        torch.from_numpy(p_logits))
    result = {
        "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "steps": TRAIN["steps"],
        "first_loss": losses[0], "last_loss": losses[-1],
        "held_out_accuracy": acc, "step_ms_median": median_ms,
        "step_ms_min": min(step_ms), "tokens_per_s": tok_s,
        "peak_memory_gb": peak_gb, "variants": variants,
        "near_margin_items": near, "label_flips_outside_margin": hard,
        "logits_rel_rms": logit_rms,
        "reference_init": {"first_loss": ref_losses[0],
                           "last_loss": ref_losses[-1],
                           "held_out_accuracy": ref_acc},
    }
    print(f"(o) training on {card_line()}: " + json.dumps(result))
    if not losses[-1] < 0.9 * losses[0] or not acc > 0.6:
        raise AssertionError(f"training: loss {losses[0]} -> {losses[-1]}, "
                             f"held-out accuracy {acc}")
    if hard:
        raise AssertionError(f"flash vs plain labels differ outside the "
                             f"margin on items {hard}")
    if not logit_rms <= TRAIN_LOGIT_RTOL:
        raise AssertionError(f"flash vs plain logits: relative RMS "
                             f"{logit_rms} (tol {TRAIN_LOGIT_RTOL})")
    if counts != dict(NO_LAUNCHES, flash_attention=cfg.n_layers):
        raise AssertionError(f"classify launches {counts}")
    paths = {"trained_classify_distilbert": counts}

    # phase (b)'s offline job on the trained params
    reset_counts()
    job = run_offline(cfg, device=dev, run=RunConfig(attn_impl="pallas"),
                      params=params, n_items=256, seq_len=TRAIN["seq_len"],
                      batch_size=TRAIN["batch"], concurrency=8, seed=SEED)
    torch.cuda.synchronize()
    paths["offline_trained_distilbert"] = read_counts()
    if not np.array_equal(job["predictions"], job["mono_predictions"]):
        raise AssertionError("trained job: parallel != monolithic")
    job_x, _ = imdb_reviews(n=256, seq_len=TRAIN["seq_len"],
                            vocab=cfg.vocab_size, seed=SEED)
    whole = kernel.classify_logits(params, job_x)
    n_near = int((np.abs(whole[:, 0] - whole[:, 1]) < TRAIN_MARGIN).sum())
    off = [int(i) for i in np.flatnonzero(
        (job["predictions"] != whole.argmax(-1))
        & (np.abs(whole[:, 0] - whole[:, 1]) >= TRAIN_MARGIN))]
    if off:
        raise AssertionError(f"merged predictions != one classify on {off}")
    print(f"(o) offline job on the trained params: accuracy "
          f"{job['accuracy']!r}, speedup "
          f"{job['mono_report'].wall_time_s / job['par_report'].wall_time_s!r}"
          f", merged predictions equal one classify of all 256 ({n_near} "
          f"within the margin)")

    # the case study as a user runs it (no --device: the card)
    reset_counts()
    case = sentiment_case_study.main([])
    torch.cuda.synchronize()
    paths["case_study_main"] = read_counts()
    if not case["accuracy"] > 0.6 or not paths["case_study_main"][
            "flash_attention"]:
        raise AssertionError(f"case study: accuracy {case['accuracy']}, "
                             f"launches {paths['case_study_main']}")
    print(f"(o) sentiment_case_study.main: held-out accuracy "
          f"{case['accuracy']!r}, losses {case['losses'][0]!r} -> "
          f"{case['losses'][-1]!r}")
    return paths


# ---------------------------------------------------------------------------
# Phase (p): the training entry points, crash and resume, and the pod step
# ---------------------------------------------------------------------------

TRAIN_CLI_STEPS, TRAIN_CLI_CRASH = 40, 20
TRAIN_CLI_TIMEOUT_S = 600
# (u3): ``launch.train --arch`` at the smoke config of the families beside
# the default decoder LM (the SSM and the MoE model), crashed and resumed
U_TRAIN_ARCHS = ("mamba2-130m", "qwen2-moe-a2.7b")
POD_RANKS, POD_STEPS = 2, 3
# the pod run's losses against the one-rank run's: the first step from the
# same params, the later ones after int8-compressed updates
POD_FIRST_RTOL, POD_LOSS_RTOL = 1e-3, 0.05


def final_checkpoint(ckpt_dir: Path) -> dict:
    step = train_checkpoint.latest_step(str(ckpt_dir))
    path = ckpt_dir / f"step_{step:010d}"
    with np.load(path / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return {"step": step, "arrays": arrays}


def start_train_cli() -> dict:
    """Start ``python -m repro_torch.launch.train`` (the default arch, then
    phase (u3)'s ``--arch`` of each family in U_TRAIN_ARCHS) and ``python
    -m repro_torch.examples.train_100m`` as a user runs them (no
    --device), each with a crash at TRAIN_CLI_CRASH and straight through:
    eight processes at once. :func:`finish_train_cli` waits for them."""
    root = ROOT / "build" / "train_cli"
    shutil.rmtree(root, ignore_errors=True)
    train = ["-m", "repro_torch.launch.train", "--smoke", "--steps",
             str(TRAIN_CLI_STEPS), "--ckpt-every", "10", "--log-every", "10"]
    commands = {
        "launch.train": train,
        "train_100m": ["-m", "repro_torch.examples.train_100m", "--steps",
                       str(TRAIN_CLI_STEPS)],
        **{f"launch.train --arch {arch}": train + ["--arch", arch]
           for arch in U_TRAIN_ARCHS},
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, argv in commands.items():
        for crash in (TRAIN_CLI_CRASH, -1):
            cmd = [sys.executable, *argv, "--ckpt-dir",
                   str(root / f"{name}_{crash}"), "--crash-at-step",
                   str(crash)]
            procs[name, crash] = subprocess.Popen(
                cmd, cwd=str(ROOT), env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return {"root": root, "commands": commands, "procs": procs,
            "t0": time.perf_counter()}


def finish_train_cli(run: dict) -> dict:
    """Wait for :func:`start_train_cli`'s processes (killing them at
    TRAIN_CLI_TIMEOUT_S); the resumed run's final checkpoint and loss
    must equal the uninterrupted run's bit for bit."""
    root, commands, procs, t0 = (run["root"], run["commands"],
                                 run["procs"], run["t0"])
    outs = {}
    try:
        for key, p in procs.items():
            left = max(TRAIN_CLI_TIMEOUT_S - (time.perf_counter() - t0), 1)
            outs[key] = p.communicate(timeout=left)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    result = {"wall_s": wall}
    for (name, crash), p in procs.items():
        if p.returncode:
            err = outs[name, crash][1][-3000:]
            raise AssertionError(f"{name} crash={crash} exited "
                                 f"{p.returncode}:\n{err}")
    for name in commands:
        crashed, straight = (outs[name, TRAIN_CLI_CRASH][0],
                             outs[name, -1][0])
        if ("CRASH" not in crashed or f"resumed from step {TRAIN_CLI_CRASH}"
                not in crashed or "CRASH" in straight):
            raise AssertionError(f"{name}: no crash and resume:\n{crashed}")
        done = [ln for out in (crashed, straight)
                for ln in out.splitlines() if ln.startswith("[train] done")]
        a = final_checkpoint(root / f"{name}_{TRAIN_CLI_CRASH}")
        b = final_checkpoint(root / f"{name}_-1")
        same = a["step"] == b["step"] == TRAIN_CLI_STEPS and \
            a["arrays"].keys() == b["arrays"].keys() and all(
                np.array_equal(a["arrays"][k], b["arrays"][k])
                for k in a["arrays"])
        final_loss = [ln.rsplit("-> ", 1)[1] for ln in done]
        if not same or len(set(final_loss)) != 1:
            raise AssertionError(f"{name}: resumed run differs from the "
                                 f"uninterrupted one ({done})")
        result[name] = {"final_loss": float(final_loss[0]),
                        "leaves": len(a["arrays"]), "bit_equal": True}
        label = "(u3)" if "--arch" in name else "(p)"
        print(f"{label} {name}: crash at step {TRAIN_CLI_CRASH}, resumed, "
              f"{TRAIN_CLI_STEPS} steps: final checkpoint ({len(a['arrays'])}"
              f" leaves) and loss {final_loss[0]} equal the uninterrupted "
              f"run's bit for bit")
    return result


def pod_worker(spec_path: str):
    """One rank of phase (p)'s pod run, started by ``spawn_ranks``: the
    full-width distilbert-imdb on a ("pod",) mesh of the ranks (gloo on
    the shared card), POD_STEPS steps with int8-compressed grads. Writes
    its losses and a digest of its master weights beside the spec."""
    spec = json.loads(Path(spec_path).read_text())
    dev = init_from_env("cuda")
    rank, world = rank_env()
    mesh = make_host_mesh((world,), ("pod",))
    cfg, model, params = distilbert_init(dev)
    x, y, _, _ = imdb_split(cfg)
    losses, digest = pod_steps(model, params, x, y, mesh)
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(
        {"losses": losses, "digest": digest}))


def pod_steps(model, params, x, y, mesh=None) -> tuple:
    """POD_STEPS AdamW steps (int8-compressed grads over "pod" when
    ``mesh`` has that axis); returns the losses and a sha256 of the
    master weights."""
    opt = adamw()
    state = opt.init(params)
    step = train_step.make_train_step(
        model, RunConfig(grad_compression="int8"), opt, mesh=mesh)
    loader = TrainLoader(x, y, batch=TRAIN["batch"], seed=SEED)
    losses = []
    with train_launch.deterministic():
        for _ in range(POD_STEPS):
            params, state, m = step(params, state, loader.next_batch())
            losses.append(float(m["loss"]))
    h = hashlib.sha256()
    for t in tree_leaves(state["master"]):
        h.update(t.cpu().numpy().tobytes())
    return losses, h.hexdigest()


def run_pod(dev) -> dict:
    """The pod step on POD_RANKS ranks sharing the card: both ranks'
    master weights bit-identical, the losses within the stated tolerance
    of the one-rank run's."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = Path(tmp, "spec.json")
        spec_path.write_text(json.dumps({"out": tmp}))
        t0 = time.perf_counter()
        done = spawn_ranks([str(ROOT / "chip_smoke.py"), "--pod-worker",
                            str(spec_path)], POD_RANKS,
                           store_path=str(Path(tmp, "store")),
                           timeout=RANK_TIMEOUT_S, cwd=str(ROOT))
        wall = time.perf_counter() - t0
        for r, p in enumerate(done):
            if p.returncode:
                raise AssertionError(f"pod rank {r} exited {p.returncode}:"
                                     f"\n{p.stderr[-4000:]}")
        res = [json.loads(Path(tmp, f"rank{r}.json").read_text())
               for r in range(POD_RANKS)]
    cfg, model, params = distilbert_init(dev)
    x, y, _, _ = imdb_split(cfg)
    one, _ = pod_steps(model, params, x, y)
    backends = sorted({ln for p in done for ln in p.stdout.splitlines()
                       if "process group backend" in ln})
    if any(r["digest"] != res[0]["digest"] or r["losses"] != res[0]["losses"]
           for r in res):
        raise AssertionError(f"pod ranks differ: {res}")
    rel = [abs(a - b) / b for a, b in zip(res[0]["losses"], one)]
    if rel[0] > POD_FIRST_RTOL or max(rel) > POD_LOSS_RTOL:
        raise AssertionError(f"pod losses {res[0]['losses']} vs one rank "
                             f"{one}")
    result = {"ranks": POD_RANKS, "steps": POD_STEPS,
              "losses": res[0]["losses"], "one_rank_losses": one,
              "loss_rel_diff": rel, "wall_s": wall, "backends": backends}
    print(f"(p) pod, int8, {POD_RANKS} ranks on {card_line()}: master "
          f"weights bit-identical on every rank; " + json.dumps(result))
    return result


def run_training_entry_points(dev) -> dict:
    """Phase (p): the CLI runs, with the pod run beside them."""
    cli = start_train_cli()
    try:
        pod = run_pod(dev)
    except BaseException:
        for p in cli["procs"].values():
            p.kill()
            p.wait()
        raise
    return {"cli": finish_train_cli(cli), "pod": pod}


# ---------------------------------------------------------------------------
# Phase (q): the remaining model families
# ---------------------------------------------------------------------------

FAMILY_SEED = SEED + 20
# (q1) gemma2-27b at full width: 8 requests over 4 slots of a 5 120-position
# cache, two prompts past the 4 096-token window of the local layers
GEMMA_PROMPTS = (4608, 4352, 256, 1024, 2048, 512, 3072, 768)
GEMMA = dict(n_slots=4, max_len=5120, new_tokens=(16, 33))
# (q2) qwen2-moe-a2.7b: 16 requests of 64-512 tokens over 8 slots
MOE = dict(n_requests=16, n_slots=8, prompt_len=(64, 513),
           new_tokens=(8, 25), max_len=544)
MOE_PREFILL_LEN = 512
# (q3) mamba2-130m: prompts of at most one 128-token SSD chunk or whole
# chunks (a 192-token prompt raises, as in the reference)
MAMBA_PROMPTS = (64, 100, 128, 256, 384, 512, 32, 128, 256, 17, 640, 128,
                 96, 384, 256, 128)
MAMBA = dict(n_slots=8, max_len=704, new_tokens=(8, 25))
# (q4)/(q5) nemotron-4-340b and grok-1-314b at full width, 2 layers each
DEEP_LAYERS = 2
DEEP = dict(n_requests=4, n_slots=4, prompt_len=(128, 513),
            new_tokens=(8, 17), max_len=544)
# (q6) jamba at the registry's smoke width (one full-width 8-layer block
# holds about 45 B params, 90 GB); smoke SSD chunk 8
JAMBA_PROMPTS = (3, 5, 8, 16, 24, 8, 16, 5)
# (q7) whisper-base: Whisper's 30 s window of 1 500 encoder frames
WHISPER = dict(batch=2, frames=1500, prompt=16, steps=32)
# einsum and scatter dispatch the same tokens: their layer outputs agree to
# bf16 rounding of the combine (relative RMS); ragged (dropless) agrees
# with einsum's routed output when fed only the (token, choice) pairs
# einsum kept, and on whole layers where nothing drops
MOE_IMPL_RTOL = 1e-2
# the fewest kept (token, choice) pairs a layer's comparison may rest on
# (a call keeps at least one expert's capacity, 36 pairs at 512 tokens)
MOE_MIN_KEPT = 32


def attention_layers(cfg) -> int:
    return sum(1 for layer in range(cfg.n_layers)
               if cfg.pattern[layer % cfg.period].mixer.startswith("attn"))


def family_model(cfg, dev, tame: bool = True):
    """A model at ``cfg`` with random weights from FAMILY_SEED on the card
    (q/k tamed unless ``tame`` is False), and its size in GB."""
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(FAMILY_SEED),
                        dev)
    if tame and not cfg.encdec:
        tame_attention(cfg, params)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size()
             for _, t in tree_leaves_with_path(params)) / 1e9
    print(f"{cfg.name}: {model.n_params / 1e9:.2f} B params, {gb:.2f} GB, "
          f"{cfg.n_layers} layers, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


def family_requests(vocab, prompt_lens, new_tokens, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=int(rng.integers(*new_tokens)))
            for rid, n in enumerate(prompt_lens)]


def family_serve(engine, params, cfg, reqs, n_slots, max_len, **kw) -> dict:
    """``reqs`` through one ContinuousBatcher, launch counts zeroed just
    before and read just after, held to what the path must launch: flash
    once an attention layer per admission (a paged admission runs the
    plain chunked path), decode (dense or paged) once an attention layer
    per round, the sampling kernel once per sampled call."""
    reqs = [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve_cluster.serve(engine, params, reqs, n_slots=n_slots,
                              max_len=max_len, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    b = res["batcher"]
    if b.take_rejected() or len(res["completed"]) != len(reqs):
        raise AssertionError(f"{cfg.name}: not every request completed")
    n_attn, paged = attention_layers(cfg), kw.get("paged", False)
    want = dict(NO_LAUNCHES,
                fused_sample=(len(reqs) + b.decode_dispatches
                              if b.fused_sampling else 0))
    want["paged_decode_attention" if paged else "decode_attention"] = \
        n_attn * b.decode_dispatches
    want["flash_attention"] = 0 if paged else n_attn * len(reqs)
    if counts != want:
        raise AssertionError(f"{cfg.name}: launches {counts}, want {want}")
    streams = {r.rid: list(r.generated) for r in reqs}
    if not all(len(s) == r.max_new_tokens for s, r in
               zip(streams.values(), reqs)):
        raise AssertionError(f"{cfg.name}: short streams")
    out = {"counts": counts, "rounds": b.rounds, "wall_s": res["wall_s"],
           "decode_ms": 1e3 * res["bucket_s"]["decode_attention"]
           / max(b.rounds, 1),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "streams": streams, "requests": reqs}
    del res, b
    return out


def serve_line(label, r) -> str:
    return (f"{label}: {r['rounds']} rounds in {r['wall_s']:.2f} s "
            f"({1e3 * r['wall_s'] / r['rounds']:.1f} ms a round with "
            f"admissions; decode {r['decode_ms']:.1f} ms a round), peak "
            f"{r['peak_gb']:.2f} GB, launches {r['counts']}")


def sampled_check(engine, params, cfg, reqs, n_slots, max_len) -> dict:
    """The fused-sampled run, every epilogue call held to the plain
    version (top-p near-ties only)."""
    with _SampleSpy() as spy:
        res = family_serve(engine, params, cfg, reqs, n_slots, max_len,
                           fused_sampling=True, **PATH_SAMPLING)
    flips = spy.flips()
    shapes = sorted({tuple(i["logits"].shape) for i, _ in spy.calls})
    n_calls = len(spy.calls)
    del spy
    check_flips(f"{cfg.name} serving", PATH_SAMPLING, flips)
    res.update(epilogue_calls=n_calls, flips=len(flips),
               epilogue_shapes=shapes)
    return res


def sharp_layer_errors(cfg, params, cache, token) -> dict:
    """``decode_layer_errors`` where the scores reach gemma2's softcap:
    every layer's wq scaled by SHARP_Q in place (tamed scores have a std
    near 1) and scaled back after (a power of two: exact). The kernel
    must agree within SHARP_RTOL on every layer, and each planted fault
    (`sharp_faults`) must break that bound: the softcap's on every layer,
    the window's on every local layer, over the rows a window 64 positions
    off cuts."""
    local = [n for n in range(cfg.n_layers)
             if cfg.pattern[n % cfg.period].mixer == "attn_local"]
    cut = cache.lengths >= cfg.window - 64
    for p in params["blocks"]:
        p["attn"]["wq"].mul_(SHARP_Q)
    try:
        with torch.no_grad():
            got = decode_layer_errors(cfg, params, cache, token)
            faults = {f: decode_layer_errors(
                cfg, params, cache, token, dataclasses.replace(
                    cfg, window=w, attn_softcap=c),
                rows=None if w == cfg.window else cut)
                for f, (w, c) in sharp_faults(cfg.window,
                                              cfg.attn_softcap).items()}
    finally:
        for p in params["blocks"]:
            p["attn"]["wq"].div_(SHARP_Q)
    caught = {f: min(e if f == "softcap off" else [e[n] for n in local])
              for f, e in faults.items()}
    print(f"gemma2-27b per-layer decode attention with wq x {SHARP_Q:g} "
          f"(scores past the softcap): kernel vs plain relative RMS max "
          f"{max(got):.3g} (tol {SHARP_RTOL}); planted faults, least error "
          f"over the layers each touches (the window's, over the "
          f"{int(cut.sum())} rows it cuts): " + ", ".join(
              f"{f} {e:.3g}" for f, e in caught.items()))
    if not all(math.isfinite(e) for e in got) or max(got) > SHARP_RTOL:
        raise AssertionError(f"gemma2 sharp decode sublayer disagrees: "
                             f"{got}")
    blind = [f for f, e in caught.items() if not e > SHARP_RTOL]
    if blind:
        raise AssertionError(f"gemma2 per-layer check passes the planted "
                             f"faults {blind}: {caught}")
    return {"rel_rms": max(got), "faults": caught}


def run_gemma2(dev) -> dict:
    """(q1): gemma2-27b at full width, all 46 layers, tamed q/k."""
    cfg = configs.get("gemma2-27b")
    model, params = family_model(cfg, dev)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    reqs = family_requests(cfg.vocab_size, GEMMA_PROMPTS,
                           GEMMA["new_tokens"], FAMILY_SEED)
    if sum(len(r.prompt) > cfg.window for r in reqs) < 2:
        raise AssertionError("two prompts must pass the local window")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (1, GEMMA["n_slots"]):
        split = fs.choose_sample_split(b, cfg.vocab_size, sms)
        if fs.staging(cfg.vocab_size, split) != "logits":
            raise AssertionError(f"B={b}: staging "
                                 f"{fs.staging(cfg.vocab_size, split)}")
    args = (GEMMA["n_slots"], GEMMA["max_len"])
    greedy = family_serve(engine, params, cfg, reqs, *args)
    print(serve_line("gemma2-27b greedy", greedy))
    sampled = sampled_check(engine, params, cfg, reqs, *args)
    print(serve_line("gemma2-27b fused sampled", sampled)
          + f"; {sampled['epilogue_calls']} epilogue calls of shapes "
          f"{sampled['epilogue_shapes']} (\"logits\" staging) held to the "
          f"plain version: {sampled['flips']} top-p near-tie flips")

    # the kernels inside the real model on one ragged cache: rows past the
    # window, per layer (decode attention with window and softcap) and a
    # profiled round
    check = engine.new_cache(*args)
    for row, req in enumerate(reqs[:GEMMA["n_slots"]]):
        engine.prefill_into(params, check, row, req.prompt[None])
    token = torch.tensor([[greedy["streams"][r.rid][0]]
                          for r in reqs[:GEMMA["n_slots"]]], device=dev)
    with torch.no_grad():
        layer_err = decode_layer_errors(cfg, params, check, token)
    if max(layer_err) > LAYER_RTOL:
        raise AssertionError(f"gemma2 decode sublayer disagrees: "
                             f"{layer_err}")
    sharp = sharp_layer_errors(cfg, params, check, token)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_round(lambda: engine.decode(params, check, token))
    round_peak = torch.cuda.max_memory_allocated() / 1e9
    idle = 1 - prof["busy_ms"] / prof["window_ms"]
    print(f"gemma2-27b per-layer decode attention (window 4096, softcap "
          f"50), kernel vs plain on the same input: relative RMS max "
          f"{max(layer_err):.3g} over {len(layer_err)} layers (tol "
          f"{LAYER_RTOL}); a decode round of {GEMMA['n_slots']} rows "
          f"(lengths {check.lengths.tolist()}): device busy "
          f"{prof['busy_ms']:.2f} ms of {prof['window_ms']:.2f} ms "
          f"(idle {idle:.3f}), {prof['launches']:.0f} launches, decode "
          f"kernel {prof['by_name']['decode_kernel']:.3f} ms, peak "
          f"{round_peak:.2f} GB; top {prof['breakdown']}")
    del check

    # the plain attention path, same requests, greedy
    plain = Engine(model, RunConfig(attn_impl="xla"), device=dev)
    reset_counts()
    res = serve_cluster.serve(plain, params, [
        Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        n_slots=GEMMA["n_slots"], max_len=GEMMA["max_len"])
    want = {r.rid: list(r.generated) for r in res["completed"]}
    if read_counts() != NO_LAUNCHES:
        raise AssertionError(f"plain path launched {read_counts()}")
    del res
    parted = hold_streams(engine, params, "gemma2-27b kernel vs plain",
                          reqs, greedy["streams"], want)
    print(f"gemma2-27b kernel path vs plain path, greedy: {parted} of "
          f"{len(reqs)} streams parted, each at a near-tie")
    return {"greedy": greedy["counts"], "sampled": sampled["counts"],
            "round": dict(prof, idle=idle, peak_gb=round_peak),
            "sharp": sharp}


class _MoeImplSpy:
    """Runs every MoE layer of one prefill through all three impls on the
    same input: keeps einsum's output and records, per layer, scatter's
    and ragged's distance from it, whether einsum and scatter drop the
    same tokens, and the routed experts' output of ragged fed only the
    (token, choice) pairs einsum kept (the gates of the dropped ones
    zeroed) against einsum's: every kept pair held, the shared expert
    left out."""

    def __init__(self):
        self.apply = moe_lib.moe_apply
        self.layers = []

    def __call__(self, cfg, mc, p, x, impl="auto"):
        y, aux = self.apply(cfg, mc, p, x, impl="einsum")
        ys = self.apply(cfg, mc, p, x, impl="scatter")[0]
        yr = self.apply(cfg, mc, p, x, impl="ragged")[0]
        routed = {k: v for k, v in p.items()
                  if k not in ("shared", "shared_gate")}
        zero = [self.apply(cfg, mc, routed, x, impl=i)[0].reshape(
                    -1, x.shape[-1]).abs().amax(-1) == 0
                for i in ("einsum", "scatter", "ragged")]
        xt = x.reshape(-1, x.shape[-1])
        gates, idx, _ = moe_lib._route(mc, p, xt)
        _, keep = moe_lib._positions_in_expert(
            mc, idx, moe_lib.capacity(mc, xt.shape[0]))
        kept = moe_lib._apply_ragged(cfg, mc, p, xt, gates * keep, idx)
        want = moe_lib._apply_einsum(cfg, mc, p, xt, gates, idx)
        self.layers.append({
            "scatter": rel_rms(ys.float(), y.float()),
            "ragged": rel_rms(yr.float(), y.float()),
            "ragged_kept": rel_rms(kept.float(), want.float()),
            "kept_pairs": int(keep.sum()),
            "same_drops": bool(torch.equal(zero[0], zero[1])),
            "tokens_dropped": int(zero[0].sum()),
            "choices_dropped": int((~keep).sum()),
            "ragged_drops": int(zero[2].sum())})
        return y, aux

    def __enter__(self):
        moe_lib.moe_apply = self
        return self

    def __exit__(self, *exc):
        moe_lib.moe_apply = self.apply


# an engine's admissions and decode rounds, logged by a _CallSpy with
# keep=round_event
ROUND_LOG = ("prefill_into", "extend_row", "decode")


def round_event(name, args, out) -> tuple:
    """One ROUND_LOG call: an admission's ("admit", row, prompt, logits),
    a round's ("round", lengths after it, logits), so two runs can be
    compared on the logits each saw at a token. An MoE row's logits
    depend on the round's other rows, so a fresh prefill of the prompt is
    no judge there."""
    logits, cache = out
    if name == "decode":
        return ("round", cache.lengths.tolist(), logits.float().clone())
    row, tokens = args[2], args[3]        # (params, cache, row, tokens)
    tokens = tokens.cpu() if torch.is_tensor(tokens) else tokens
    return ("admit", int(row), tuple(np.asarray(tokens)[0].tolist()),
            logits[0].float().clone())


def logits_at(log, prompt, i) -> tuple:
    """(event index, the logits) the request with ``prompt`` took its
    token ``i`` from, in a log of ``round_event``s."""
    prompt = tuple(int(t) for t in prompt)
    start, row = next((n, e[1]) for n, e in enumerate(log)
                      if e[0] == "admit" and e[2] == prompt)
    if i == 0:
        return start, log[start][3]
    for n, e in enumerate(log[start + 1:], start + 1):
        if e[0] == "admit" and e[1] == row:
            break
        if e[0] == "round" and e[1][row] == len(prompt) + i:
            return n, e[2][row]
    raise AssertionError(f"no logits for token {i}")


def parted_at_logged_near_ties(reqs, want, got, log_want, log_got) -> int:
    """Streams equal, or parted at a near-tie of the logits ``want``'s run
    saw at the first differing token: both tokens within max(LOGIT_FLOOR,
    the largest difference between the two runs' logits there) of the
    best, and those logits within PATH_RTOL of each other (each row's
    logits must depend on its own tokens only: dense MLPs or the "ragged"
    MoE dispatch). Returns how many parted."""
    partings = []
    for r in reqs:
        a, b = want[r.rid], got[r.rid]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            n, lw = logits_at(log_want.log, r.prompt, i)
            partings.append((n, r.rid, i, a[i], b[i], lw,
                             logits_at(log_got.log, r.prompt, i)[1]))
    for _, rid, i, x, y, lw, lg in sorted(partings, key=lambda p: p[0]):
        tie = max(LOGIT_FLOOR, float((lw - lg).abs().max()))
        gaps = (float(lw.max() - lw[x]), float(lw.max() - lw[y]))
        err = rel_rms(lg, lw)
        if max(gaps) > tie or err > PATH_RTOL:
            raise AssertionError(
                f"request {rid} parts at token {i} ({x} vs {y}) with logit "
                f"gaps {gaps}, tie {tie}, logits relative RMS {err}")
    return len(partings)


def run_qwen2_moe(dev) -> dict:
    """(q2): qwen2-moe-a2.7b at full width, 24 layers, tamed q/k: dense
    serving on the default MoE dispatch ("auto": einsum at these token
    counts), then dense and paged bf16 on "ragged", whose rows do not
    depend on each other (the capacity-bound dispatches make a row's
    logits move with the free rows' stale tokens, which the dense and
    paged caches hold differently), held to each other; then the three
    MoE impls on one prefill."""
    cfg = configs.get("qwen2-moe-a2.7b")
    model, params = family_model(cfg, dev)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    ragged = Engine(model, RunConfig(attn_impl="pallas", moe_impl="ragged"),
                    device=dev)
    reqs = serve_cluster.make_requests(cfg.vocab_size, MOE["n_requests"],
                                       MOE["prompt_len"], MOE["new_tokens"],
                                       FAMILY_SEED)
    args = (MOE["n_slots"], MOE["max_len"])
    auto = family_serve(engine, params, cfg, reqs, *args)
    print(serve_line("qwen2-moe-a2.7b dense, auto (einsum)", auto))
    with _CallSpy(ragged, ROUND_LOG, keep=round_event) as dense_log:
        dense = family_serve(ragged, params, cfg, reqs, *args)
    print(serve_line("qwen2-moe-a2.7b dense, ragged", dense))
    with _CallSpy(ragged, ROUND_LOG, keep=round_event) as paged_log:
        paged = family_serve(ragged, params, cfg, reqs, *args, paged=True)
    print(serve_line("qwen2-moe-a2.7b paged bf16, ragged", paged))
    parted = parted_at_logged_near_ties(reqs, dense["streams"],
                                        paged["streams"], dense_log,
                                        paged_log)
    del dense_log, paged_log
    differ = sum(auto["streams"][r.rid] != dense["streams"][r.rid]
                 for r in reqs)
    print(f"qwen2-moe-a2.7b paged vs dense streams (ragged): {parted} of "
          f"{len(reqs)} parted, each at a near-tie of the round's own "
          f"logits; einsum vs ragged dispatch: {differ} of {len(reqs)} "
          f"streams differ (capacity drops, by design)")
    if parted > len(reqs) // 3:
        raise AssertionError(f"{parted} of {len(reqs)} parted")
    prompt = torch.tensor(np.random.default_rng(FAMILY_SEED).integers(
        0, cfg.vocab_size, (1, MOE_PREFILL_LEN)).astype(np.int32),
        device=dev)
    # the served capacity, then one at which no choice drops (capacity =
    # the tokens of the call), on the same params
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    impls = {}
    for label, m in (("served capacity", model),
                     ("no drops", build_model(roomy))):
        with _MoeImplSpy() as spy, torch.no_grad():
            m.prefill(RunConfig(attn_impl="pallas"), params,
                      {"tokens": prompt})
        impls[label] = spy.layers
        worst = {k: max(layer[k] for layer in spy.layers)
                 for k in ("scatter", "ragged", "ragged_kept")}
        kept = min(layer["kept_pairs"] for layer in spy.layers)
        drops = sum(layer["tokens_dropped"] for layer in spy.layers)
        choices = sum(layer["choices_dropped"] for layer in spy.layers)
        print(f"qwen2-moe-a2.7b MoE impls on one {MOE_PREFILL_LEN}-token "
              f"prefill, {label}, {len(spy.layers)} layers: scatter vs "
              f"einsum relative RMS max {worst['scatter']:.3g}; ragged fed "
              f"einsum's kept (token, choice) pairs vs einsum, routed "
              f"experts only, max {worst['ragged_kept']:.3g} over at least "
              f"{kept} kept pairs a layer; ragged vs einsum whole layers "
              f"max {worst['ragged']:.3g} (tol {MOE_IMPL_RTOL}); {choices} "
              f"(token, choice) pairs and {drops} whole tokens dropped by "
              f"capacity over the layers, the same tokens in einsum and "
              f"scatter: {all(layer['same_drops'] for layer in spy.layers)};"
              f" ragged drops "
              f"{sum(layer['ragged_drops'] for layer in spy.layers)}")
        held = ("scatter", "ragged_kept") + (
            ("ragged",) if label == "no drops" else ())
        if (not all(math.isfinite(layer[k]) for layer in spy.layers
                    for k in held)
                or max(worst[k] for k in held) > MOE_IMPL_RTOL
                or kept < MOE_MIN_KEPT
                or not all(layer["same_drops"] for layer in spy.layers)
                or any(layer["ragged_drops"] for layer in spy.layers)
                or (label == "no drops" and choices)):
            raise AssertionError(f"MoE impls disagree ({label}): "
                                 f"{spy.layers}")
    return {"dense": auto["counts"], "dense_ragged": dense["counts"],
            "paged": paged["counts"]}


def run_mamba2(dev) -> dict:
    """(q3): mamba2-130m at full width, 24 layers, batcher traffic greedy
    and fused sampled; each stream against the request served alone."""
    cfg = configs.get("mamba2-130m")
    model, params = family_model(cfg, dev)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    with expect_raises(ValueError, "divisible by ssd chunk"):
        engine.prefill(params, np.zeros((1, 3 * cfg.ssm.chunk // 2),
                                        np.int32))
    reqs = family_requests(cfg.vocab_size, MAMBA_PROMPTS,
                           MAMBA["new_tokens"], FAMILY_SEED)
    args = (MAMBA["n_slots"], MAMBA["max_len"])
    with _CallSpy(engine, ROUND_LOG, keep=round_event) as log:
        greedy = family_serve(engine, params, cfg, reqs, *args)
    print(serve_line("mamba2-130m greedy", greedy))
    sampled = sampled_check(engine, params, cfg, reqs, *args)
    print(serve_line("mamba2-130m fused sampled", sampled))
    # each request alone: its own prefill and decode rounds in a batcher of
    # the same slots (the same GEMM shapes; a fresh prefill of prompt +
    # tokens is no judge: its length must fill whole SSD chunks)
    alone = {}
    with _CallSpy(engine, ROUND_LOG, keep=round_event) as alone_log:
        for r in reqs:
            alone.update(family_serve(engine, params, cfg, [r],
                                      *args)["streams"])
    parted = parted_at_logged_near_ties(reqs, alone, greedy["streams"],
                                        alone_log, log)
    del log, alone_log
    print(f"mamba2-130m batcher streams vs each request alone (prefill + "
          f"decode rounds of its own): {parted} of {len(reqs)} parted, each "
          f"at a near-tie of the logits each run saw")
    if parted > len(reqs) // 3:
        raise AssertionError(f"{parted} of {len(reqs)} parted")
    return {"greedy": greedy["counts"], "sampled": sampled["counts"]}


@contextlib.contextmanager
def expect_raises(exc, match):
    try:
        yield
    except exc as e:
        if match not in str(e):
            raise
    else:
        raise AssertionError(f"no {exc.__name__} raised")


def run_deep(dev, arch) -> dict:
    """(q4)/(q5): ``arch`` at full width cut to DEEP_LAYERS layers (its
    params do not fit on one card), 4 requests greedy on the kernels, held
    to the plain path."""
    cfg = dataclasses.replace(configs.get(arch), n_layers=DEEP_LAYERS)
    model, params = family_model(cfg, dev)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    reqs = serve_cluster.make_requests(cfg.vocab_size, DEEP["n_requests"],
                                       DEEP["prompt_len"], DEEP["new_tokens"],
                                       FAMILY_SEED)
    args = (DEEP["n_slots"], DEEP["max_len"])
    def head_dim(name, a, out):
        return a[0].shape[-1]
    with _CallSpy(fa_ops, ("flash_attention",), keep=head_dim) as flash, \
            _CallSpy(da_ops, ("decode_attention",), keep=head_dim) as decode:
        greedy = family_serve(engine, params, cfg, reqs, *args)
    dims = sorted({("flash", d) for d in flash.log}
                  | {("decode", d) for d in decode.log})
    if dims != [("decode", cfg.head_dim), ("flash", cfg.head_dim)]:
        raise AssertionError(f"{arch}: kernels ran at {dims}")
    print(serve_line(f"{arch} ({DEEP_LAYERS} of "
                     f"{configs.get(arch).n_layers} layers) greedy", greedy)
          + f"; flash and decode at head_dim {cfg.head_dim}")
    plain = Engine(model, RunConfig(attn_impl="xla"), device=dev)
    res = serve_cluster.serve(plain, params, [
        Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        n_slots=args[0], max_len=args[1])
    want = {r.rid: list(r.generated) for r in res["completed"]}
    parted = hold_streams(engine, params, f"{arch} kernel vs plain", reqs,
                          greedy["streams"], want)
    print(f"{arch} kernel path vs plain path: {parted} of {len(reqs)} "
          f"streams parted, each at a near-tie")
    return greedy["counts"]


def run_jamba(dev) -> dict:
    """(q6): jamba at the registry's smoke width: the hybrid cache (SSM
    state and KV layers) through the batcher, flash and decode on its
    attention layers."""
    cfg = configs.smoke("jamba-1.5-large-398b")
    model, params = family_model(cfg, dev)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    reqs = family_requests(cfg.vocab_size, JAMBA_PROMPTS, (4, 13),
                           FAMILY_SEED)
    res = family_serve(engine, params, cfg, reqs, 3, 40)
    print(serve_line(f"jamba smoke ({cfg.n_layers} layers, "
                     f"{attention_layers(cfg)} attention)", res))
    return res["counts"]


def tame_whisper(cfg, params):
    """``tame_attention`` for the encoder-decoder's three attentions."""
    d = cfg.d_model
    for p in params["enc_blocks"]:
        for w, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads)):
            p["attn"][w].mul_(math.sqrt(heads / d))
    for p in params["dec_blocks"]:
        for a in ("self_attn", "cross_attn"):
            p[a]["wq"].mul_(math.sqrt(cfg.n_heads / d))
            p[a]["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))


def run_whisper(dev) -> dict:
    """(q7): whisper-base at full width: encode 1 500 frames, prefill the
    decoder teacher-forced, then greedy decode steps; the plain path fed
    the same tokens."""
    cfg = configs.get("whisper-base")
    model, params = family_model(cfg, dev, tame=False)
    tame_whisper(cfg, params)
    w = WHISPER
    g = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    batch = {"enc_embeds": torch.randn(w["batch"], w["frames"], cfg.d_model,
                                       generator=g, device=dev
                                       ).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (w["batch"], w["prompt"]), generator=g,
                                     device=dev)}
    max_len = w["prompt"] + w["steps"]
    runs = {}
    for impl in ("pallas", "xla"):
        run = RunConfig(attn_impl=impl)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = model.prefill(run, params, batch,
                                          max_len=max_len)
            steps = [logits]
            tokens = runs["pallas"]["tokens"] if impl == "xla" else []
            for i in range(w["steps"]):
                tok = (tokens[i] if impl == "xla"
                       else steps[-1].argmax(-1, keepdim=True))
                if impl == "pallas":
                    tokens.append(tok)
                logits, cache = model.decode_step(run, params, cache,
                                                  {"token": tok})
                steps.append(logits)
        torch.cuda.synchronize()
        runs[impl] = {"logits": torch.stack(steps), "tokens": tokens,
                      "counts": read_counts(),
                      "s": time.perf_counter() - t0}
    n = cfg.n_layers
    want = dict(NO_LAUNCHES, flash_attention=cfg.n_enc_layers + 2 * n
                + w["steps"] * n, decode_attention=w["steps"] * n)
    if runs["pallas"]["counts"] != want or runs["xla"]["counts"] != \
            NO_LAUNCHES:
        raise AssertionError(f"whisper launches {runs['pallas']['counts']},"
                             f" want {want}; plain {runs['xla']['counts']}")
    got, ref = runs["pallas"]["logits"], runs["xla"]["logits"]
    if not torch.isfinite(got).all():
        raise AssertionError("whisper logits not finite")
    err = max(rel_rms(a.float(), b.float()) for a, b in zip(got, ref))
    same = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"whisper-base: encode {w['frames']} frames x {w['batch']}, "
          f"prefill {w['prompt']} tokens, {w['steps']} greedy decode steps "
          f"on the kernels in {runs['pallas']['s']:.2f} s, launches "
          f"{runs['pallas']['counts']} (cross-attention through flash at "
          f"S 1 x T {w['frames']}); the plain path fed the same tokens: "
          f"logits relative RMS max {err:.3g} over the steps (tol "
          f"{PATH_RTOL}), argmax equal in {same:.3f} of rows")
    if err > PATH_RTOL:
        raise AssertionError(f"whisper kernel vs plain: {err}")
    return runs["pallas"]["counts"]


def run_families(phase) -> dict:
    """Phase (q), path by path; returns each path's launch counts."""
    paths = {}
    for name, fn in (("gemma2_27b", run_gemma2),
                     ("qwen2_moe_a2_7b", run_qwen2_moe),
                     ("mamba2_130m", run_mamba2),
                     (f"nemotron_4_340b_{DEEP_LAYERS}_layers",
                      lambda d: run_deep(d, "nemotron-4-340b")),
                     (f"grok_1_314b_{DEEP_LAYERS}_layers",
                      lambda d: run_deep(d, "grok-1-314b")),
                     ("jamba_smoke", run_jamba),
                     ("whisper_base", run_whisper)):
        out = phase(f"(q) {name}", fn)
        if name in ("gemma2_27b", "qwen2_moe_a2_7b", "mamba2_130m"):
            for mode, counts in out.items():
                if mode not in ("round", "sharp"):
                    paths[f"{name}_{mode}"] = counts
        else:
            paths[name] = out
        torch.cuda.empty_cache()
    return paths


def control_plane_phases(phase) -> dict:
    """Phases (i)-(m); returns their paths' launch counts."""
    paths = {"fig2_distilbert": phase(
        "(i) Fig. 2, distilbert-imdb compute", run_fig2)["counts"]}
    lm = phase("(j) full-width qwen2-7b, tamed q/k", control_plane_model)
    paths["router_qwen2_7b"] = phase(
        "(j) router, qwen2-7b", lambda d: run_router_phase(d, lm))["counts"]
    paths["calibrated_router_qwen2_7b"] = phase(
        "(k) calibration, qwen2-7b",
        lambda d: run_calibration(d, lm))["counts"]
    paths["http_qwen2_7b"] = phase(
        "(l) HTTP front door, qwen2-7b",
        lambda d: run_http_phase(d, lm))["counts"]
    del lm
    torch.cuda.empty_cache()
    paths.update(phase("(m) launch.serve's command line", run_cli))
    return paths


# ---------------------------------------------------------------------------
# Phase (r): tensor-parallel params and a data axis, ranks sharing the card
# ---------------------------------------------------------------------------

# The configs phase (r) serves (``configs.get``: full width; a CPU
# rehearsal points it at ``configs.smoke``) and its device.
R_CONFIG = configs.get
# r2: qwen2-7b, all 28 layers, 8 requests of 64-256 tokens, 16 new each,
# over 8 slots of 512 positions; each mesh (shape, seq_shard) in turn, the
# sampled pass on the first two data/model layouts
R_GEN = dict(n_requests=8, prompt_len=(64, 257), new_tokens=(16, 17),
             n_slots=8, max_len=512)
R_QWEN = [((1, 2), False), ((1, 4), False), ((2, 1), False),
          ((2, 2), False), ((2, 2), True)]
R_SAMPLED = [(2, 1), (1, 2)]
# (1, 4), the slowest layout (446.5 ms a round on an H100: PERF.md §5),
# at R_M4_LAYERS of the 28 layers, held to one rank at that depth: with
# it at 28 the whole script ran 1 135 s of its 1 200 s on a slow host
# once phase (t) rode the same spawns, past the 85% mark (PERF.md §6)
R_M4, R_M4_LAYERS = (1, 4), 8
# sampled streams that may part from the one-rank run's, each at a near-tie:
# three quarters of them in all (a stream makes 16 Gumbel-max draws, and
# the gap between a draw's two best scores is near 0 often enough that
# logits 0.04 apart flip one of 16 in most streams), and a quarter past
# the draw-gap bound (at the edge of the top-k or top-p filter, where
# every logit moves the cutoff)
R_SAMPLED_PARTS = 3 * R_GEN["n_requests"] // 4
R_EDGE_PARTS = R_GEN["n_requests"] // 4
# r3: qwen2-moe-a2.7b at full width, MOE_LAYERS of its 24 layers (cut for
# the run's time: 8.3 GB of params a whole copy), an (8, 256) prefill
# through the scatter dispatch, and continuous batching
MOE_LAYERS = 6
R_MOE = [(2, 1), (1, 2)]
R_MOE_PREFILL = (8, 256)
# r1: distilbert-imdb through ``launch.serve --mesh 2x2 --full-width``
R_CLF_ARGV = ["--mesh", "2x2", "--full-width", "--arch", "distilbert-imdb",
              "--n-items", "256", "--seq-len", "128", "--batch-size", "32",
              "--seed", str(SEED)]
R_TIMEOUT_S = 900
# teacher-forced decode rounds after the admissions, on the one-rank greedy
# tokens: the logits' difference there sets the near-tie bound
R_FORCED = 8


def r_requests(cfg, gen=R_GEN):
    return serve_cluster.make_requests(
        cfg.vocab_size, gen["n_requests"], gen["prompt_len"],
        gen["new_tokens"], SEED)


def r_serve(engine, params, cfg, gen=R_GEN, **kw) -> dict:
    """r2's (or ``gen``'s) continuous batching with the launch counts
    around it."""
    reqs = r_requests(cfg, gen)
    torch.cuda.synchronize()
    reset_counts()
    res = serve_cluster.serve(engine, params, reqs,
                              n_slots=gen["n_slots"],
                              max_len=gen["max_len"], seed=SEED, **kw)
    torch.cuda.synchronize()
    b = res["batcher"]
    if b.take_rejected() or len(res["completed"]) != len(reqs):
        raise AssertionError("r2: requests rejected or left undone")
    return {"streams": [r.generated for r in reqs], "counts": read_counts(),
            "rounds": b.rounds, "wall_s": res["wall_s"],
            "tokens": res["tokens"]}


def moe_config(no_drops: bool):
    """qwen2-moe at MOE_LAYERS layers; ``no_drops`` sets the capacity
    factor that gives every expert room for every token (E / k)."""
    cfg = dataclasses.replace(R_CONFIG("qwen2-moe-a2.7b"),
                              n_layers=MOE_LAYERS)
    if no_drops:
        mc = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            mc, capacity_factor=mc.num_experts / mc.top_k))
    return cfg


def r_init(model, dev, shardings=None):
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev,
                        shardings=shardings)
    tame_attention(model.cfg, params)
    return params


def planned_bytes(model, engine) -> int:
    """Param bytes of this rank's shard as the planner cuts them."""
    specs = dict(tree_leaves_with_path(model.param_specs,
                                       lambda x: hasattr(x, "axes")))
    return sum(int(np.prod(cut.local_shape(specs[path].shape)))
               * specs[path].dtype.itemsize
               for path, cut in tree_leaves_with_path(engine.params_sharding))


def want_collectives(cfg, shape, seq: bool) -> dict:
    """Collective calls of one decode round on one rank of a (D, M) mesh:
    "model" under "tp": the all_reduce after wo and w2 in every layer and
    after the vocab-split embedding lookup, the gather of the vocab-split
    logits; seq-shard: the MAX and SUM merge of every layer; data: the
    gather of the round's logits; and a MoE layer's router gather
    (experts cut over "model") and its tokens' gather (rows cut over the
    data axes: a decode round dispatches by "einsum")."""
    d, m = shape
    moe = sum(cfg.pattern[i % cfg.period].mlp == "moe"
              for i in range(cfg.n_layers))
    want = {}
    if m > 1 and seq:
        want["all_reduce"] = 2 * cfg.n_layers
    elif m > 1:
        split = cfg.vocab_size % m == 0
        want["all_reduce"] = 2 * cfg.n_layers + split
        # an expert-split router's logits are gathered in every MoE layer
        gathers = split + (moe if cfg.moe and cfg.moe.num_experts % m == 0
                           else 0)
        if gathers:
            want["all_gather_model"] = gathers
    if d > 1:  # a round's MoE dispatch ("einsum") spans every row
        want["all_gather_data"] = 1 + moe
    return want


def tp_lm_job(dev, job, rank) -> dict:
    """One r2/r3 layout on this rank: params drawn as this rank's shard
    (tamed q/k), admission logits, one decode round's launches and
    collectives (counted, then timed), greedy (and sampled) serving."""
    shape, seq = tuple(job["shape"]), job.get("seq", False)
    if job["arch"] == "qwen2-7b":
        cfg = R_CONFIG("qwen2-7b")
        if job.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=job["layers"])
    else:
        cfg = moe_config(job.get("no_drops", False))
    model = build_model(cfg)
    mesh = make_host_mesh(shape, tuple(job.get("axes", ("data", "model"))))
    run = serve_cluster.RUN
    engine = Engine(model, run, device=dev, mesh=mesh, seq_shard=seq)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    # one rank draws at a time: a draw holds one whole leaf (qwen2-7b's
    # embed in fp32, 2.2 GB) beside the rank's shard, and four whole
    # seq-shard copies (15.23 GB each) leave no room for four such peaks
    for r in range(int(np.prod(shape))):
        if r == rank:
            params = r_init(model, dev, engine.params_sharding)
            torch.cuda.synchronize()
        torch.distributed.barrier()
    out = {"shape": shape, "seq": seq, "strategy": engine.strategy,
           "layers": cfg.n_layers,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "planned_bytes": planned_bytes(model, engine),
           "memory_allocated": torch.cuda.memory_allocated(dev) - mem0,
           "whole_bytes": sum(int(np.prod(s.shape)) * s.dtype.itemsize
                              for s in tree_leaves(
                                  model.param_specs,
                                  lambda x: hasattr(x, "axes")))}
    if "prefill" in job:  # r3's dispatch check on one batch
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, job["prefill"]).astype(np.int32)
        scatter = Engine(model, dataclasses.replace(run, moe_impl="scatter"),
                         device=dev, mesh=mesh)
        out["prefill_logits"] = scatter.prefill(params, toks)[0].cpu()
    # admission logits and one decode round on a fresh cache
    reqs = r_requests(cfg)
    cache = engine.new_cache(R_GEN["n_slots"], R_GEN["max_len"])
    heads = []
    flash = fa_ops.flash_attention

    def spy(q, *a, **kw):
        heads.append((int(q.shape[2]), int(a[0].shape[2])))
        return flash(q, *a, **kw)

    fa_ops.flash_attention = spy
    try:
        logits = [engine.prefill_into(params, cache, row, r.prompt[None])[0]
                  for row, r in enumerate(reqs[:R_GEN["n_slots"]])]
    finally:
        fa_ops.flash_attention = flash
    out["admission_logits"] = torch.cat(logits).cpu()
    out["flash_heads"] = sorted(set(heads))
    out["cache_block"] = list(cache.layers[0]["k"].shape)
    # teacher-forced rounds on the one-rank greedy tokens; the first one's
    # launches and collectives counted
    forced = []
    for j, toks in enumerate(job["forced"]):
        tok = torch.tensor(toks, device=dev, dtype=torch.int32)[:, None]
        if j == 0:
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset_stats()
        forced.append(engine.decode(params, cache, tok)[0].cpu())
        if j == 0:
            torch.cuda.synchronize()
            out["round_launches"] = read_counts()
            out["round_collectives"] = {k: v[0] for k, v in
                                        collectives.STATS.items()}
    out["forced_logits"] = torch.stack(forced)
    out["round_ms"] = cuda_ms(lambda: engine.decode(params, cache, tok),
                              iters=3, warmup=1)
    collectives.reset_stats()
    collectives.set_timing(True)
    n = 3
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            engine.decode(params, cache, tok)
        torch.cuda.synchronize()
        out["timed_round_ms"] = 1e3 * (time.perf_counter() - t0) / n
    finally:
        collectives.set_timing(False)
    out["collective_ms_per_round"] = {k: 1e3 * v[1] / n for k, v in
                                      collectives.STATS.items()}
    del cache
    out["greedy"] = r_serve(engine, params, cfg)
    if job.get("sampled"):
        kw = dict(fused_sampling=True, **serve_cluster.SAMPLING)
        if shape[0] == 1:  # every rank samples the whole batch's rows:
            # keep its draw where a stream parts from the one-rank run's
            from repro_torch.serving import engine as engine_mod
            with _Draws(engine_mod) as m:
                out["sampled"] = r_serve(engine, params, cfg, **kw)
            out["sampled"]["draws"] = {
                (rid, i): m.draw[(rid, i)]
                for rid, (a, b) in enumerate(zip(job["sampled"],
                                                 out["sampled"]["streams"]))
                for i in [next((j for j, (x, y) in enumerate(zip(a, b))
                                if x != y), None)] if i is not None}
        else:
            out["sampled"] = r_serve(engine, params, cfg, **kw)
    del params, engine
    torch.cuda.empty_cache()
    return out


def tp_clf_job(dev, job, rank) -> dict:
    """r1 on this rank: ``launch.serve.main`` with ``--mesh 2x2`` as a
    user runs it (this process is one of its ranks), the init tamed, the
    classify calls, flash launches and their heads counted; then the same
    params' logits on the same mesh."""
    from repro_torch.models import model_zoo
    init = model_zoo.Model.init
    classify = Engine.classify_logits
    flash = fa_ops.flash_attention
    calls, heads = [], set()

    def tamed(self, *a, **kw):
        params = init(self, *a, **kw)
        tame_attention(self.cfg, params)
        return params

    def counted(self, *a, **kw):
        calls.append(1)
        return classify(self, *a, **kw)

    def spy(q, *a, **kw):
        heads.add((int(q.shape[2]), int(a[0].shape[2])))
        return flash(q, *a, **kw)

    model_zoo.Model.init, Engine.classify_logits = tamed, counted
    fa_ops.flash_attention = spy
    torch.cuda.synchronize()
    reset_counts()
    collectives.reset_stats()
    t0 = time.perf_counter()
    try:
        out = serve.main(job["argv"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stats = {k: v[0] for k, v in collectives.STATS.items()}
        cfg = R_CONFIG("distilbert-imdb")
        model = build_model(cfg)
        engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev,
                        mesh=make_host_mesh((2, 2)))
        params = model.init(torch.Generator().manual_seed(SEED), dev,
                            shardings=engine.params_sharding)
    finally:
        model_zoo.Model.init, Engine.classify_logits = init, classify
        fa_ops.flash_attention = flash
    tokens = clf_tokens(cfg)
    bs = int(job["argv"][job["argv"].index("--batch-size") + 1])
    logits = np.concatenate([engine.classify_logits(params, tokens[i:i + bs])
                             for i in range(0, len(tokens), bs)])
    return {"predictions": list(out["predictions"]),
            "accuracy": out["accuracy"], "mono": out["mono"],
            "par": out["par"], "wall_s": wall, "classify_calls": len(calls),
            "launches": counts, "flash_heads": sorted(heads),
            "collectives": stats, "logits": logits,
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "planned_bytes": planned_bytes(model, engine)}


def clf_tokens(cfg):
    argv = R_CLF_ARGV
    n = int(argv[argv.index("--n-items") + 1])
    s = int(argv[argv.index("--seq-len") + 1])
    return imdb_reviews(n=n, seq_len=s, vocab=cfg.vocab_size, seed=SEED)[0]


def tp_worker(spec_path: str):
    """One rank of phases (r) and (s), started by
    ``launch.mesh.spawn_ranks``: the spec's jobs for this world size in
    turn, each result written beside the spec by every rank (rank 0's is
    the one held; the others' streams must equal it)."""
    spec = json.loads(Path(spec_path).read_text())
    dev = init_from_env(spec["device"])
    rank, world = rank_env()
    out = {}
    run = {"clf": tp_clf_job, "lm": tp_lm_job, "zero_train": zero_train_job,
           "zero_serve": zero_serve_job, "t_family": t_family_job,
           "t_slices": t_slices_job, "t_cli": t_cli_job,
           "u_http": u_http_job}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        print(f"job {job['name']} starts", flush=True)
        out[job["name"]] = run[job["kind"]](dev, job, rank)
        out[job["name"]]["job_s"] = time.perf_counter() - t0
        print(f"job {job['name']}: {out[job['name']]['job_s']:.1f} s",
              flush=True)
    torch.save(out, Path(spec["out"], f"rank{rank}.pt"))


def run_tp_ranks(dev, world: int, jobs: list) -> list:
    """``jobs`` on ``world`` ranks sharing the card: each rank's results."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = Path(tmp, "spec.json")
        spec_path.write_text(json.dumps({"jobs": jobs, "out": tmp,
                                         "device": dev.type}))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        done = spawn_ranks([str(ROOT / "chip_smoke.py"), "--tp-worker",
                            str(spec_path)], world,
                           store_path=str(Path(tmp, "store")),
                           timeout=R_TIMEOUT_S, cwd=str(ROOT), env=env)
        failed = [f"rank {r} of {world} exited {p.returncode}:\n"
                  f"{p.stdout[-1500:]}\n{p.stderr[-3000:]}"
                  for r, p in enumerate(done) if p.returncode]
        if failed:
            raise AssertionError("(r) " + "\n".join(failed))
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


class _Draws:
    """A fused-sampled run's draws, kept for judging where two sampled
    streams part: for every committed token, its row's logits and Gumbel
    noise (on the host). The run's batcher is set as ``batcher`` with
    ``on_token`` as its callback, or is the one ``serve_cluster.serve``
    makes inside the block."""

    def __init__(self, engine_mod):
        self.mod, self.fn = engine_mod, engine_mod.fused_sample
        self.make = serve_cluster.ContinuousBatcher
        self.pending, self.draw, self.batcher = [], {}, None

    def __enter__(self):
        def sample(logits, generator=None, *, noise=None, **kw):
            if noise is None:
                noise = fs.gumbel_noise(logits.shape, generator,
                                        logits.device)
            rows = ([0] if logits.shape[0] == 1
                    else self.batcher.scheduler.active)
            lg, nz = logits.float().cpu(), noise.cpu()
            self.pending.extend((lg[r], nz[r]) for r in rows)
            return self.fn(logits, generator, noise=noise, **kw)

        def make(*a, **kw):
            self.batcher = self.make(*a, on_token=self.on_token, **kw)
            return self.batcher

        self.mod.fused_sample = sample
        serve_cluster.ContinuousBatcher = make
        return self

    def on_token(self, req, tok, prefill):
        self.draw[(req.rid, len(req.generated) - 1)] = self.pending.pop(0)

    def __exit__(self, *exc):
        self.mod.fused_sample = self.fn
        serve_cluster.ContinuousBatcher = self.make
        self.batcher = None


def sampled_parted_at_near_ties(dev, draws, want, got, tie, kw,
                                mesh_draws=None,
                                limits=(R_SAMPLED_PARTS, R_EDGE_PARTS)
                                ) -> list:
    """Sampled streams equal token for token, or parted only where the
    mesh's logits, within ``tie`` of the one-rank run's, explain it (both
    runs draw the same noise and sample through the kernel). Where the
    mesh's own draw is known (``mesh_draws``: its ranks sample the whole
    batch), the parting is replayed: the two draws' noise is equal, their
    logits differ by at most ``tie``, and the kernel on each draw's
    logits and noise gives that run's token. Else b stays in the filters
    with its logit raised by 2 tie, and its ``logit / T + noise`` is
    within 2 tie / T of the drawn token a's. At most ``limits`` = (R_SAMPLED_PARTS,
    R_EDGE_PARTS) streams may part, the second of them past that
    draw-gap bound.
    Returns each parting's [stream, token, draw gap
    (one-rank logits), bound, logit difference at the draw (None
    without the mesh's draw), a droppable by a 2-tie move]."""
    parted = []
    t, bound = kw["temperature"], 2 * tie / kw["temperature"]

    def kept(logits):
        return fs.apply_filters(logits[None], **kw)[0] > fs.NEG_INF / 2

    def replay(logits, noise) -> int:
        return int(fs.fused_sample(logits.to(dev)[None],
                                   noise=noise.to(dev)[None], **kw)[0])

    for rid, (a, b) in enumerate(zip(want, got)):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        logits, noise = draws[(rid, i)]
        ta, tb = a[i], b[i]
        y = logits / t + noise
        gap = float(y[ta] - y[tb])
        lowered = logits.clone()
        lowered[ta] -= 2 * tie
        droppable = not bool(kept(lowered)[ta])
        if mesh_draws is not None:
            mlogits, mnoise = mesh_draws[(rid, i)]
            diff = float((mlogits - logits).abs().max())
            ok = (torch.equal(mnoise, noise) and diff <= tie
                  and replay(logits, noise) == ta
                  and replay(mlogits, mnoise) == tb)
        else:
            raised = logits.clone()
            raised[tb] += 2 * tie
            diff = None
            ok = bool(kept(raised)[tb]) and gap <= bound
        if not ok:
            raise AssertionError(
                f"sampled stream {rid} parts at token {i} ({ta} vs {tb}): "
                f"draw gap {gap} (bound {bound}), logits apart by {diff} "
                f"at the draw (tie {tie}), a droppable {droppable}")
        parted.append([rid, i, gap, bound, diff, droppable])
    edge = sum(p[2] > bound for p in parted)
    if len(parted) > limits[0] or edge > limits[1]:
        raise AssertionError(
            f"{len(parted)} sampled streams parted, {edge} past the draw "
            f"gap bound; at most {limits[0]} and {limits[1]} may: "
            f"{parted}")
    return parted


def forced_tokens(greedy, gen=R_GEN, rounds: int = R_FORCED) -> list:
    """``rounds`` rounds of the first ``gen["n_slots"]`` requests' greedy
    tokens: the inputs of the teacher-forced rounds."""
    streams = greedy["streams"][:gen["n_slots"]]
    return [[s[j] for s in streams] for j in range(rounds)]


def one_rank_lm(dev, cfg, prefill=None, halves: bool = False,
                sampled: bool = False, gen=R_GEN,
                rounds: int = R_FORCED) -> dict:
    """The one-rank engine's results on the same params and requests:
    admission logits, greedy streams, (``prefill``) the logits of an
    (8, 256) batch, whole or as two halves (the scatter dispatch's groups
    over a data axis of 2), (``sampled``) the fused-sampled streams with
    each draw's logits and noise."""
    from repro_torch.serving import engine as engine_mod
    model = build_model(cfg)
    params = r_init(model, dev)
    run = dataclasses.replace(serve_cluster.RUN, moe_impl="scatter")
    engine = Engine(model, serve_cluster.RUN, device=dev)
    out = {}
    if prefill is not None:
        toks = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, prefill).astype(np.int32)
        eng = Engine(model, run, device=dev)
        parts = np.split(toks, 2) if halves else [toks]
        out["prefill_logits"] = torch.cat(
            [eng.prefill(params, p)[0] for p in parts]).cpu()
    reqs = r_requests(cfg, gen)
    cache = engine.new_cache(gen["n_slots"], gen["max_len"])
    out["admission_logits"] = torch.cat(
        [engine.prefill_into(params, cache, row, r.prompt[None])[0]
         for row, r in enumerate(reqs[:gen["n_slots"]])]).cpu()
    out["greedy"] = r_serve(engine, params, cfg, gen)
    forced = []
    for toks in forced_tokens(out["greedy"], gen, rounds):
        tok = torch.tensor(toks, device=dev, dtype=torch.int32)[:, None]
        forced.append(engine.decode(params, cache, tok)[0].cpu())
    out["forced_logits"] = torch.stack(forced)
    del cache
    if sampled:
        with _Draws(engine_mod) as m:
            reqs = r_requests(cfg, gen)
            b = ContinuousBatcher(engine, params, n_slots=gen["n_slots"],
                                  max_len=gen["max_len"], seed=SEED,
                                  fused_sampling=True, on_token=m.on_token,
                                  **serve_cluster.SAMPLING)
            m.batcher = b
            b.submit_many(reqs)
            b.run()
        m.batcher = None  # the batcher and its params go with this frame
        out["sampled"] = {"streams": [r.generated for r in reqs],
                          "draws": m.draw}
    return out


def judge_greedy(dev, cfg, prompts, want, got, tie) -> int:
    """``parted_at_near_ties`` with the one-rank engine, whose params are
    drawn again (tamed) only where a stream parted."""
    if all(a == b for a, b in zip(want, got)):
        return 0
    model = build_model(cfg)
    engine = Engine(model, serve_cluster.RUN, device=dev)
    parted = parted_at_near_ties(engine, r_init(model, dev), prompts, want,
                                 got, tie)
    del engine
    torch.cuda.empty_cache()
    return parted


def check_lm_layout(dev, name, cfg, ranks, ref) -> dict:
    """Hold one r2/r3 layout's ranks to the one-rank engine: streams equal
    on every rank; admission (and prefill) logits within PATH_RTOL; greedy
    (and sampled) streams parted only at near-ties; one decode round's
    launches (the decode kernel, or the partials kernel, once a layer)
    and collectives (``want_collectives``); the shard's bytes the
    planner's; the flash kernel's local heads; the launches over the
    serving runs."""
    res = ranks[0]
    shape, seq = tuple(res["shape"]), res["seq"]
    # the data axes taken together, then "model" (the last axis)
    d, m = int(np.prod(shape[:-1])), shape[-1]
    for other in ranks[1:]:
        for mode in ("greedy", "sampled"):
            if mode in res and other[mode]["streams"] != res[mode]["streams"]:
                raise AssertionError(f"{name}: ranks' {mode} streams differ")
    err = rel_rms(res["admission_logits"], ref["admission_logits"])
    ferr = rel_rms(res["forced_logits"], ref["forced_logits"])
    diff = max(float((res[k] - ref[k]).abs().max())
               for k in ("admission_logits", "forced_logits"))
    tie = NOISE_FACTOR * diff + LOGIT_FLOOR
    out = {"admission_rel_rms": err, "forced_rel_rms": ferr,
           "max_abs_diff": diff, "near_tie_bound": tie}
    if "prefill_logits" in ref:
        out["prefill_rel_rms"] = rel_rms(res["prefill_logits"],
                                         ref["prefill_logits"])
    if max(err, ferr, out.get("prefill_rel_rms", 0.0)) > PATH_RTOL:
        raise AssertionError(f"{name}: logits vs one rank {out}")
    prompts = [r.prompt for r in r_requests(cfg)]
    out["greedy_parted"] = judge_greedy(dev, cfg, prompts,
                                        ref["greedy"]["streams"],
                                        res["greedy"]["streams"], tie)
    if "sampled" in res:
        out["sampled_partings"] = sampled_parted_at_near_ties(
            dev, ref["sampled"]["draws"], ref["sampled"]["streams"],
            res["sampled"]["streams"], tie, serve_cluster.SAMPLING,
            res["sampled"].get("draws"))
        out["sampled_parted"] = len(out["sampled_partings"])
    kernel = "decode_attention_partials" if seq else "decode_attention"
    want = dict(NO_LAUNCHES, **{kernel: cfg.n_layers})
    wcol = want_collectives(cfg, (d, m), seq)
    for r, x in enumerate(ranks):
        if x["round_launches"] != want:
            raise AssertionError(f"{name} rank {r}: a round launched "
                                 f"{x['round_launches']}, want {want}")
        got = {k: v for k, v in x["round_collectives"].items() if v}
        if got != wcol:
            raise AssertionError(f"{name} rank {r}: a round's collectives "
                                 f"{got}, want {wcol}")
        if x["param_bytes"] != x["planned_bytes"]:
            raise AssertionError(f"{name} rank {r}: {x['param_bytes']} "
                                 f"param bytes, planned "
                                 f"{x['planned_bytes']}")
    if m > 1 and not seq and res["param_bytes"] >= res["whole_bytes"]:
        raise AssertionError(f"{name}: params not cut over 'model'")
    hl = cfg.n_heads // m  # kv heads: the rank's, or those its q use
    kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0
          else attention.kv_group(cfg, hl, 0)[1])
    heads = set() if seq else {(hl, kv)}
    if set(map(tuple, res["flash_heads"])) != heads:
        raise AssertionError(f"{name}: flash heads {res['flash_heads']}, "
                             f"want {heads}")
    # serving launches: per rank, the decode kernel every round; over the
    # data ranks of one model line, the flash kernel once a layer an
    # admission and (sampled) the sampling kernel once an admission, and
    # on each rank once a round (on the gathered logits under "model")
    line = ranks[:d * m:m]
    for mode in ("greedy", "sampled"):
        if mode not in res:
            continue
        counts = [x[mode]["counts"] for x in line]
        rounds = res[mode]["rounds"]
        n = R_GEN["n_requests"]
        flash = sum(c["flash_attention"] for c in counts)
        decode = {c[kernel] for c in counts}
        sample = sum(c["fused_sample"] for c in counts)
        want_sample = n + d * rounds if mode == "sampled" else 0
        if flash != (0 if seq else cfg.n_layers * n) or \
                decode != {cfg.n_layers * rounds} or sample != want_sample:
            raise AssertionError(
                f"{name} {mode}: flash {flash}, {kernel} {decode}, "
                f"sampling {sample} over the data ranks ({rounds} rounds, "
                f"want sampling {want_sample})")
        out[f"{mode}_sampling_launches"] = sample
    out.update({k: res[k] for k in (
        "strategy", "layers", "param_bytes", "planned_bytes",
        "whole_bytes", "memory_allocated", "cache_block", "flash_heads",
        "round_collectives", "round_ms", "timed_round_ms",
        "collective_ms_per_round", "job_s")})
    out["memory_allocated_per_rank"] = [x["memory_allocated"]
                                        for x in ranks]
    out["greedy_tokens_per_s"] = (res["greedy"]["tokens"]
                                  / res["greedy"]["wall_s"])
    print(f"(r) {name}: {json.dumps(out)}")
    return out


def check_clf(dev, ranks, cfg) -> dict:
    """r1: ``launch.serve --mesh 2x2`` on full-width distilbert-imdb
    against the one-rank classifier on the same (tamed) params."""
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED), dev)
    tame_attention(cfg, params)
    engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
    tokens = clf_tokens(cfg)
    bs = int(R_CLF_ARGV[R_CLF_ARGV.index("--batch-size") + 1])
    one = np.concatenate([engine.classify_logits(params, tokens[i:i + bs])
                          for i in range(0, len(tokens), bs)])
    del params, engine
    res = ranks[0]
    if any(x["predictions"] != res["predictions"] for x in ranks):
        raise AssertionError("(r1) ranks' predictions differ")
    logits = res["logits"]
    err = rel_rms(torch.as_tensor(logits), torch.as_tensor(one))
    diff = float(np.abs(logits - one).max())
    tie = NOISE_FACTOR * diff + LOGIT_FLOOR
    labels = one.argmax(-1)
    preds = np.asarray(res["predictions"])
    flips = np.flatnonzero(preds != labels)
    gap = np.abs(one[:, 0] - one[:, 1])
    hard = [int(i) for i in flips if gap[i] > tie]
    if err > PATH_RTOL or hard or not np.array_equal(preds,
                                                     logits.argmax(-1)):
        raise AssertionError(f"(r1) vs one rank: rel RMS {err}, flips "
                             f"past near-ties {hard}")
    for r, x in enumerate(ranks):
        if x["launches"]["flash_attention"] != \
                cfg.n_layers * x["classify_calls"] or \
                [tuple(h) for h in x["flash_heads"]] != [
                    (cfg.n_heads // 2, cfg.n_kv_heads // 2)]:
            raise AssertionError(f"(r1) rank {r}: {x['launches']} for "
                                 f"{x['classify_calls']} classify calls, "
                                 f"heads {x['flash_heads']}")
        if x["param_bytes"] != x["planned_bytes"]:
            raise AssertionError(f"(r1) rank {r}: param bytes")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": [2, 2],
           "argv": R_CLF_ARGV, "logit_rel_rms": err, "max_abs_diff": diff,
           "label_flips": len(flips), "near_tie_bound": tie,
           "accuracy": res["accuracy"], "classify_calls_per_rank":
           [x["classify_calls"] for x in ranks],
           "flash_launches_per_rank": [x["launches"]["flash_attention"]
                                       for x in ranks],
           "flash_heads": res["flash_heads"],
           "param_bytes_per_rank": res["param_bytes"],
           "collectives_rank0": res["collectives"],
           "mono_wall_min": res["mono"]["wall_time_min"],
           "par_wall_min": res["par"]["wall_time_min"],
           "serve_main_s": res["wall_s"], "job_s": res["job_s"]}
    print(f"(r) r1_distilbert_serve_mesh_2x2: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase (s): the ZeRO-3 layouts ("fsdp", "fsdp_tp") on phase (r)'s spawns
# ---------------------------------------------------------------------------

# s1: distilbert-imdb at full width, S_CLF_STEPS AdamW steps of phase (o)'s
# batches (its fan-in q/k, its schedule) under each layout on (2, 2), then
# the fsdp_tp-trained shards classify phase (o)'s held-out reviews
S_CLF_STEPS = 4
S_CLF = [((2, 2), "fsdp"), ((2, 2), "fsdp_tp")]
# s2: qwen2-7b at full width, S_QWEN_LAYERS of its 28 layers (AdamW's state
# for 28 is about 137 GB), S_QWEN_STEPS steps of next-token batches
S_QWEN_LAYERS, S_QWEN_STEPS, S_QWEN_BATCH = 2, 2, (4, 128)
# s3: mamba2-130m, all 24 layers, under "fsdp" on (2, 1)
S_MAMBA_STEPS, S_MAMBA_BATCH = 3, (4, 256)
# s4: qwen2-7b, all 28 layers, served under "fsdp_tp" on (2, 2)
S_GEN = dict(n_requests=4, prompt_len=(64, 257), new_tokens=(8, 9),
             n_slots=4, max_len=512)
S_FORCED = 2
# a sharded step against one rank, both in bf16: the first step's loss and
# grad norm (the same params on both sides) within S_LOSS_RTOL /
# S_GNORM_RTOL, the later steps' within S_TRAJ_RTOL (AdamW moves a weight
# by about +-lr whatever its grad's size, so a grad within rounding of 0
# may step either way and the two runs' params part), the first step's
# grads (s1, s3) within S_GRAD_RTOL relative RMS over the tree, the
# params' change over the steps within S_UPDATE_RTOL relative RMS; s4's
# param bytes a rank within S_MEM_RTOL of ``memory_allocated`` after the
# init. Each bound must sit between two readings of the same run: the
# sound twin (one rank again, each batch's rows in reverse order: the
# same loss and grads summed in another order) must pass every bound, and
# the mesh step with S_FAULT planted must break one. S_TRAJ_RTOL and
# S_UPDATE_RTOL are the geometric means, to one figure, of the largest
# sound and the smallest faulty reading on an H100 (later steps 0.0315
# and 0.291, the update 0.245 and 0.814: PERF.md §6, PR 22); the other
# bounds already sat between the two (the first step's loss, computed
# before any grad, is the forward's check: the fault cannot move it)
S_LOSS_RTOL, S_GNORM_RTOL, S_GRAD_RTOL = 1e-2, 2e-2, 5e-2
S_TRAJ_RTOL, S_UPDATE_RTOL, S_MEM_RTOL = 0.1, 0.4, 0.01
# the planted fault: grads not summed over the data axes (each rank steps
# on its own rows' grads)
S_FAULT = "not_summed"


def s_train_setup(what: str, reverse: bool = False):
    """(cfg, tame q/k?, batches, optimizer) of an s1-s3 training job; the
    batches are drawn from SEED, the same in every process (``reverse``:
    each batch's rows in reverse order, the sound twin's)."""
    cfg, tame, batches, opt = _s_train_setup(what)
    if reverse:
        batches = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
                   for b in batches]
    return cfg, tame, batches, opt


def _s_train_setup(what: str):
    if what == "clf":
        cfg = configs.get("distilbert-imdb")
        x, y, _, _ = imdb_split(cfg)
        loader = TrainLoader(x, y, batch=TRAIN["batch"], seed=SEED)
        return cfg, True, [loader.next_batch()
                           for _ in range(S_CLF_STEPS)], adamw()
    if what == "whisper":  # t1's training: frames, then 64-token targets
        cfg = R_CONFIG("whisper-base")
        rng = np.random.default_rng(SEED)
        (b, n), batches = T_WHISPER_BATCH, []
        for _ in range(T_WHISPER_STEPS):
            t = rng.integers(0, cfg.vocab_size, (b, n + 1)).astype(np.int32)
            batches.append({"enc_embeds": rng.standard_normal(
                (b, T_WHISPER["frames"], cfg.enc_d_model), dtype=np.float32),
                "tokens": t[:, :-1], "labels": t[:, 1:]})
        return (cfg, True, batches,
                optimizer.AdamW(schedule=optimizer.constant(1e-4)))
    if what == "qwen":
        cfg = dataclasses.replace(R_CONFIG("qwen2-7b"),
                                  n_layers=S_QWEN_LAYERS)
        shape, steps, lr = S_QWEN_BATCH, S_QWEN_STEPS, 1e-4
    else:
        cfg = R_CONFIG("mamba2-130m")
        shape, steps, lr = S_MAMBA_BATCH, S_MAMBA_STEPS, 1e-4
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(steps):
        t = rng.integers(0, cfg.vocab_size,
                         (shape[0], shape[1] + 1)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return (cfg, what == "qwen", batches,
            optimizer.AdamW(schedule=optimizer.constant(lr)))


def s_init(model, dev, tame: bool, shardings=None):
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev,
                        shardings=shardings)
    if tame:
        (tame_whisper if model.cfg.encdec else tame_attention)(model.cfg,
                                                               params)
    return params


class _FirstGrads:
    """An optimizer that keeps the grads of its first update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, shardings=None):
        if self.grads is None:
            self.grads = grads
        return self.opt.update(grads, state, params, shardings=shardings)


def s_steps(step, params, state, batches) -> tuple:
    """The steps, each one's loss, grad norm and ms on CUDA events."""
    metrics = []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "ms": start.elapsed_time(end)})
    return params, state, metrics


def s_reference_train(dev, what: str, path: Path) -> dict:
    """One rank's run of an s1-s3 job: each step's metrics; the params
    after the steps and the first step's grads (s1, s3) saved whole to
    ``path`` for the ranks to read their blocks of; s1's held-out
    logits."""
    cfg, tame, batches, opt = s_train_setup(what)
    model = build_model(cfg)
    params = s_init(model, dev, tame)
    rec = _FirstGrads(opt)
    step = train_step.make_train_step(model, RunConfig(), rec)
    params, _, metrics = s_steps(step, params, rec.init(params), batches)
    torch.save({"params": tree_map(lambda t: t.cpu(), params),
                "grads": None if what == "qwen" else
                tree_map(lambda t: t.cpu(), rec.grads)}, path)
    out = {"metrics": metrics}
    if what == "clf":
        _, _, held_x, _ = imdb_split(cfg)
        engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev)
        out["held_logits"] = engine.classify_logits(params, held_x)
    del params, rec, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def s_sound_twin(dev, what: str, path: Path, ref: dict) -> dict:
    """The sound reading of an s1-s3 job: one rank again on the batches
    with their rows reversed, held to the reference run (saved at
    ``path``) as the mesh is: each step's loss and grad norm, the update
    and (s1, s3) the first grads."""
    cfg, tame, batches, opt = s_train_setup(what, reverse=True)
    model = build_model(cfg)
    params = s_init(model, dev, tame)
    base = tree_map(lambda t: t.cpu(), params)
    rec = _FirstGrads(opt)
    step = train_step.make_train_step(model, RunConfig(), rec)
    params, _, metrics = s_steps(step, params, rec.init(params), batches)
    saved = torch.load(path, mmap=True, weights_only=False)

    def errors(got, want, zero):  # s_errors of one rank holding it all
        zero = dict(tree_leaves_with_path(zero)) if zero else {}
        out = {}
        for (p, t), w in zip(tree_leaves_with_path(got), tree_leaves(want)):
            w = w.to(t.device).float()
            b = zero[p].to(t.device).float() if p in zero else 0.0
            out[p] = [float(((t.float() - w) ** 2).sum()),
                      float(((w - b) ** 2).sum())]
        return out
    update = [errors(params, saved["params"], base)]
    grads = (None if saved["grads"] is None else
             [errors(rec.grads, saved["grads"], None)])
    del params, rec, step, base
    gc.collect()
    torch.cuda.empty_cache()
    return s_readings(metrics, ref["metrics"], update, grads)


def s_readings(metrics, ref_metrics, update, grads) -> dict:
    """A run held to the one-rank reference: each step's relative loss
    and grad-norm difference, the update's and (given) the first grads'
    relative RMS over the ranks' blocks."""
    out = {f"{key}_rel": [abs(g[key] - w[key]) / abs(w[key]) for g, w in
                          zip(metrics, ref_metrics)]
           for key in ("loss", "grad_norm")}
    out["update_rel_rms"] = s_rel(update)
    if grads is not None:
        out["grad_rel_rms"] = s_rel(grads)
    return out


def s_broken(r: dict) -> list:
    """The bounds that readings ``r`` break."""
    later = r["loss_rel"][1:] + r["grad_norm_rel"][1:]
    return [name for name, bad in (
        ("loss", r["loss_rel"][0] > S_LOSS_RTOL),
        ("grad_norm", r["grad_norm_rel"][0] > S_GNORM_RTOL),
        ("trajectory", max(later, default=0.0) > S_TRAJ_RTOL),
        ("update", r["update_rel_rms"] > S_UPDATE_RTOL),
        ("grads", r.get("grad_rel_rms", 0.0) > S_GRAD_RTOL)) if bad]


def s_planted(fault):
    """Patches that break the sharded step as S_FAULT says (``fault``
    None: none); returns their undoing."""
    if fault is None:
        return lambda: None
    rs, sw = collectives._reduce_scatter, train_step._sum_whole_leaves
    collectives._reduce_scatter = lambda g, group, index, n: \
        g[index].clone()
    train_step._sum_whole_leaves = lambda grads, sums: grads

    def undo():
        collectives._reduce_scatter = rs
        train_step._sum_whole_leaves = sw
    return undo


def s_errors(got, ref, base, shardings, mesh) -> dict:
    """path -> [sum of (got - ref)^2, sum of (ref - base)^2] over this
    rank's blocks (``base`` None: of ref^2), each element counted on one
    rank only (``Sharding.counted_here``)."""
    out = {}
    cuts = dict(tree_leaves_with_path(shardings, lambda x: isinstance(
        x, shd.Sharding)))
    whole = dict(tree_leaves_with_path(ref))
    zero = dict(tree_leaves_with_path(base)) if base is not None else {}
    for path, t in tree_leaves_with_path(got):
        if not cuts[path].counted_here(mesh):
            continue
        r = cuts[path].slice(whole[path]).to(t.device).float()
        b = zero[path].to(t.device).float() if path in zero else 0.0
        out[path] = [float(((t.float() - r) ** 2).sum()),
                     float(((r - b) ** 2).sum())]
    return out


def zero_train_job(dev, job, rank) -> dict:
    """One s1-s3 layout on this rank: the shards drawn in turn, the steps
    under ``make_train_step(mesh=, strategy=)``, the params' and first
    grads' errors against the reference's blocks, and (s1 under
    "fsdp_tp") the trained shards classifying the held-out reviews
    through ``Engine(strategy="fsdp_tp")`` on the flash kernel."""
    cfg, tame, batches, opt = s_train_setup(job["what"])
    model = build_model(cfg)
    shape, strategy = tuple(job["shape"]), job["strategy"]
    mesh = make_host_mesh(shape)
    sh = shd.param_shardings(model.param_specs, strategy, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    for r in range(int(np.prod(shape))):
        if r == rank:
            params = s_init(model, dev, tame, sh)
            torch.cuda.synchronize()
        torch.distributed.barrier()
    base = tree_map(lambda t: t.cpu(), params)  # the card is shared
    rec = _FirstGrads(opt)
    step = train_step.make_train_step(model, RunConfig(), rec, mesh=mesh,
                                      strategy=strategy)
    collectives.reset_stats()
    undo = s_planted(job.get("fault"))
    try:
        params, _, metrics = s_steps(step, params, rec.init(params),
                                     batches)
    finally:
        undo()
    stats = {k: v[0] for k, v in collectives.STATS.items()}
    ref = torch.load(job["ref"], mmap=True, weights_only=False)
    out = {"shape": shape, "strategy": strategy, "metrics": metrics,
           "collectives": stats,
           "update": s_errors(params, ref["params"], base, sh, mesh),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "planned_bytes": shd.rank_param_bytes(model.param_specs,
                                                 strategy, mesh),
           "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    if ref["grads"] is not None:
        out["grads"] = s_errors(rec.grads, ref["grads"], None, sh, mesh)
    del base, rec, step
    if job.get("serve"):
        _, _, held_x, _ = imdb_split(cfg)
        engine = Engine(model, RunConfig(attn_impl="pallas"), device=dev,
                        mesh=mesh, strategy="fsdp_tp")
        flash, heads = fa_ops.flash_attention, set()

        def spy(q, *a, **kw):
            heads.add((int(q.shape[2]), int(a[0].shape[2])))
            return flash(q, *a, **kw)
        torch.cuda.synchronize()
        reset_counts()
        fa_ops.flash_attention = spy
        try:
            out["held_logits"] = engine.classify_logits(params, held_x)
        finally:
            fa_ops.flash_attention = flash
        torch.cuda.synchronize()
        out["serve_launches"] = read_counts()
        out["flash_heads"] = sorted(heads)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zero_gathers(model, mesh) -> int:
    """``param_gather``'s all_gathers in one pass over the layers under
    "fsdp_tp": per unit (the embedding, each layer, the final norm, the
    head) one a set of (ZeRO axes, dtype) among its cut leaves."""
    sh = shd.param_shardings(model.param_specs, "fsdp_tp", mesh)
    specs = model.param_specs

    def packs(sub, sub_sh) -> int:
        cuts = dict(tree_leaves_with_path(sub_sh, lambda x: isinstance(
            x, shd.Sharding)))
        return len({(cuts[p].zero_axes, s.dtype) for p, s in
                    tree_leaves_with_path(sub, lambda x: hasattr(x, "axes"))
                    if cuts[p].zero})
    return sum(packs(specs["blocks"][i], sh["blocks"][i])
               for i in range(len(specs["blocks"]))) + sum(
        packs(specs[k], sh[k]) for k in specs if k != "blocks")


def zero_serve_job(dev, job, rank) -> dict:
    """s4 on this rank: qwen2-7b's 28 layers under "fsdp_tp" on (2, 2),
    the shards drawn in turn (tamed q/k), the bytes held against the
    planner's and ``memory_allocated``; admission logits (flash heads
    spied), teacher-forced rounds (the first one's launches and
    collectives counted, then rounds timed, the gathers timed), greedy
    and fused-sampled continuous batching."""
    cfg = R_CONFIG("qwen2-7b")
    model = build_model(cfg)
    mesh = make_host_mesh((2, 2))
    engine = Engine(model, serve_cluster.RUN, device=dev, mesh=mesh,
                    strategy="fsdp_tp")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    for r in range(4):
        if r == rank:
            params = r_init(model, dev, engine.params_sharding)
            torch.cuda.synchronize()
        torch.distributed.barrier()
    out = {"param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "planned_bytes": shd.rank_param_bytes(model.param_specs,
                                                 "fsdp_tp", mesh),
           "memory_allocated": torch.cuda.memory_allocated(dev) - mem0,
           "gathers_a_pass": zero_gathers(model, mesh)}
    reqs = r_requests(cfg, S_GEN)
    cache = engine.new_cache(S_GEN["n_slots"], S_GEN["max_len"])
    heads, flash = [], fa_ops.flash_attention

    def spy(q, *a, **kw):
        heads.append((int(q.shape[2]), int(a[0].shape[2])))
        return flash(q, *a, **kw)
    fa_ops.flash_attention = spy
    try:
        logits = [engine.prefill_into(params, cache, row, r.prompt[None])[0]
                  for row, r in enumerate(reqs[:S_GEN["n_slots"]])]
    finally:
        fa_ops.flash_attention = flash
    out["admission_logits"] = torch.cat(logits).cpu()
    out["flash_heads"] = sorted(set(heads))
    forced = []
    for j, toks in enumerate(job["forced"]):
        tok = torch.tensor(toks, device=dev, dtype=torch.int32)[:, None]
        if j == 0:
            torch.cuda.synchronize()
            reset_counts()
            collectives.reset_stats()
        forced.append(engine.decode(params, cache, tok)[0].cpu())
        if j == 0:
            torch.cuda.synchronize()
            out["round_launches"] = read_counts()
            out["round_collectives"] = {k: v[0] for k, v in
                                        collectives.STATS.items()}
    out["forced_logits"] = torch.stack(forced)
    out["round_ms"] = cuda_ms(lambda: engine.decode(params, cache, tok),
                              iters=3, warmup=1)
    collectives.reset_stats()
    collectives.set_timing(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            engine.decode(params, cache, tok)
        torch.cuda.synchronize()
        out["timed_round_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    finally:
        collectives.set_timing(False)
    out["collective_ms_per_round"] = {k: 1e3 * v[1] / 3 for k, v in
                                      collectives.STATS.items()}
    del cache
    out["greedy"] = r_serve(engine, params, cfg, S_GEN)
    out["sampled"] = r_serve(engine, params, cfg, S_GEN, fused_sampling=True,
                             **serve_cluster.SAMPLING)
    del params, engine
    torch.cuda.empty_cache()
    return out


def s_rel(errs: list, key: str = None) -> float:
    """sqrt(sum of squared differences / sum of squares), summed over the
    ranks' blocks."""
    num = sum(e[p][0] for e in errs for p in e)
    den = sum(e[p][1] for e in errs for p in e)
    return math.sqrt(num / max(den, 1e-30))


def check_zero_train(name, ranks, ref) -> dict:
    """Hold one s1-s3 layout to one rank: every rank's metrics equal; each
    step's loss and grad norm, the update and (s1, s3) the first grads
    within their bounds (with S_FAULT planted: past one of them); the
    shards' bytes the planner's."""
    res = ranks[0]
    seen = [[(m["loss"], m["grad_norm"]) for m in x["metrics"]]
            for x in ranks]
    if any(v != seen[0] for v in seen) or not np.isfinite(seen).all():
        raise AssertionError(f"(s) {name}: each rank's (loss, grad norm) "
                             f"{seen}, one rank's {ref['metrics']}")
    out = {"strategy": res["strategy"], "mesh": list(res["shape"])}
    out.update(s_readings(res["metrics"], ref["metrics"],
                          [x["update"] for x in ranks],
                          [x["grads"] for x in ranks]
                          if "grads" in res else None))
    broken = s_broken(out)
    if name.endswith(S_FAULT):
        if not broken:
            raise AssertionError(f"(s) {name}: the planted fault passed "
                                 f"every bound {out}")
        out["broken"] = broken
        return out
    if broken:
        raise AssertionError(f"(s) {name}: {broken} vs one rank {out}")
    for r, x in enumerate(ranks):
        if x["param_bytes"] != x["planned_bytes"]:
            raise AssertionError(f"(s) {name} rank {r}: "
                                 f"{x['param_bytes']} param bytes, planned "
                                 f"{x['planned_bytes']}")
    out.update(param_bytes_per_rank=res["param_bytes"],
               peak_allocated_per_rank=[x["peak_allocated"] for x in ranks],
               step_ms=[m["ms"] for m in res["metrics"]],
               one_rank_step_ms=[m["ms"] for m in ref["metrics"]],
               collectives_rank0=res["collectives"])
    return out


def check_zero_clf(name, ranks, ref, cfg) -> dict:
    """s1's serving: the fsdp_tp-trained shards' held-out labels against
    the one-rank trained classifier's, parting only at near-ties; flash
    at 6 local heads, once a layer a classify call on every rank."""
    res = ranks[0]
    logits, one = res["held_logits"], ref["held_logits"]
    for x in ranks[1:]:
        if not np.array_equal(x["held_logits"], logits):
            raise AssertionError(f"(s) {name}: ranks' logits differ")
    err = rel_rms(torch.as_tensor(logits), torch.as_tensor(one))
    diff = float(np.abs(logits - one).max())
    tie = NOISE_FACTOR * diff + LOGIT_FLOOR
    near, hard = near_tie_labels(logits, one, tie)
    heads = [(cfg.n_heads // 2, cfg.n_kv_heads // 2)]
    for r, x in enumerate(ranks):  # one classify call of every row
        if [tuple(h) for h in x["flash_heads"]] != heads or \
                x["serve_launches"]["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"(s) {name} rank {r}: flash "
                                 f"{x['serve_launches']}, heads "
                                 f"{x['flash_heads']}")
    if err > PATH_RTOL or hard:
        raise AssertionError(f"(s) {name}: held-out logits vs one rank: "
                             f"rel RMS {err}, label flips past near-ties "
                             f"{hard}")
    return {"held_logit_rel_rms": err, "max_abs_diff": diff,
            "near_tie_items": near, "labels_equal": int(
                (logits.argmax(-1) == one.argmax(-1)).sum()),
            "flash_launches_per_rank": [
                x["serve_launches"]["flash_attention"] for x in ranks],
            "flash_heads": heads}


def check_zero_serve(dev, ranks, ref) -> dict:
    """s4 against one rank: streams equal on every rank; admission and
    teacher-forced logits within PATH_RTOL; greedy and sampled streams
    parted only at near-ties; a round's launches (decode once a layer)
    and collectives (``want_collectives`` of "tp" on (2, 2) plus
    ``zero_gathers`` layer gathers); bytes a rank the planner's, and
    ``memory_allocated`` after the init within S_MEM_RTOL of them; the
    serving runs' launches."""
    cfg = R_CONFIG("qwen2-7b")
    res = ranks[0]
    for x in ranks[1:]:
        for mode in ("greedy", "sampled"):
            if x[mode]["streams"] != res[mode]["streams"]:
                raise AssertionError(f"(s4) ranks' {mode} streams differ")
    err = rel_rms(res["admission_logits"], ref["admission_logits"])
    ferr = rel_rms(res["forced_logits"], ref["forced_logits"])
    diff = max(float((res[k] - ref[k]).abs().max())
               for k in ("admission_logits", "forced_logits"))
    tie = NOISE_FACTOR * diff + LOGIT_FLOOR
    out = {"admission_rel_rms": err, "forced_rel_rms": ferr,
           "max_abs_diff": diff, "near_tie_bound": tie}
    if max(err, ferr) > PATH_RTOL:
        raise AssertionError(f"(s4) logits vs one rank {out}")
    prompts = [r.prompt for r in r_requests(cfg, S_GEN)]
    out["greedy_parted"] = judge_greedy(dev, cfg, prompts,
                                        ref["greedy"]["streams"],
                                        res["greedy"]["streams"], tie)
    n = S_GEN["n_requests"]
    out["sampled_partings"] = sampled_parted_at_near_ties(
        dev, ref["sampled"]["draws"], ref["sampled"]["streams"],
        res["sampled"]["streams"], tie, serve_cluster.SAMPLING,
        limits=(3 * n // 4, n // 4))
    want = dict(NO_LAUNCHES, decode_attention=cfg.n_layers)
    wcol = dict(want_collectives(cfg, (2, 2), False),
                all_gather_param=res["gathers_a_pass"])
    for r, x in enumerate(ranks):
        got = {k: v for k, v in x["round_collectives"].items() if v}
        if x["round_launches"] != want or got != wcol:
            raise AssertionError(f"(s4) rank {r}: a round launched "
                                 f"{x['round_launches']} with collectives "
                                 f"{got}; want {want}, {wcol}")
        if x["param_bytes"] != x["planned_bytes"] or abs(
                x["memory_allocated"] - x["planned_bytes"]) > \
                S_MEM_RTOL * x["planned_bytes"]:
            raise AssertionError(f"(s4) rank {r}: {x['param_bytes']} param "
                                 f"bytes, {x['memory_allocated']} allocated,"
                                 f" planned {x['planned_bytes']}")
    heads = {(cfg.n_heads // 2, cfg.n_kv_heads // 2)}
    if set(map(tuple, res["flash_heads"])) != heads:
        raise AssertionError(f"(s4) flash heads {res['flash_heads']}")
    # every rank runs every admission (its layers' gathers span the data
    # ranks): flash once a layer an admission and, sampled, the sampling
    # kernel once an admission on every rank; the decode kernel once a
    # layer a round; the sampling kernel once a round on each rank's rows
    for mode in ("greedy", "sampled"):
        rounds = res[mode]["rounds"]
        for r, x in enumerate(ranks):
            c = x[mode]["counts"]
            want_sample = n + rounds if mode == "sampled" else 0
            if c["flash_attention"] != cfg.n_layers * n or \
                    c["decode_attention"] != cfg.n_layers * rounds or \
                    c["fused_sample"] != want_sample:
                raise AssertionError(f"(s4) {mode} rank {r}: {c} over "
                                     f"{rounds} rounds")
    out.update({k: res[k] for k in (
        "param_bytes", "planned_bytes", "memory_allocated",
        "gathers_a_pass", "flash_heads", "round_collectives", "round_ms",
        "timed_round_ms", "collective_ms_per_round", "job_s")})
    out["memory_allocated_per_rank"] = [x["memory_allocated"]
                                        for x in ranks]
    out["greedy_tokens_per_s"] = (res["greedy"]["tokens"]
                                  / res["greedy"]["wall_s"])
    return out


def zero_jobs(dev, tmp: Path) -> tuple:
    """Phase (s)'s jobs for the 2- and 4-rank spawns and its one-rank
    references (computed here, before the spawns)."""
    refs = {}
    for what in ("clf", "qwen", "mamba", "whisper"):
        t = time.perf_counter()
        refs[what] = s_reference_train(dev, what, tmp / f"s_{what}.pt")
        refs[what]["twin"] = s_sound_twin(dev, what, tmp / f"s_{what}.pt",
                                          refs[what])
        refs[what]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    refs["serve"] = one_rank_lm(dev, R_CONFIG("qwen2-7b"), sampled=True,
                                gen=S_GEN, rounds=S_FORCED)
    refs["serve"]["s"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    jobs = {2: [dict(kind="zero_train", what="mamba", shape=(2, 1),
                     strategy="fsdp", name="s3 mamba2 fsdp(2, 1)",
                     ref=str(tmp / "s_mamba.pt"))],
            4: [dict(kind="zero_train", what="clf", shape=s, strategy=st,
                     name=f"s1 distilbert {st}{s}",
                     ref=str(tmp / "s_clf.pt"), serve=st == "fsdp_tp")
                for s, st in S_CLF]
            + [dict(kind="zero_train", what="qwen", shape=(2, 2),
                    strategy="fsdp_tp", name="s2 qwen2-7b fsdp_tp(2, 2)",
                    ref=str(tmp / "s_qwen.pt")),
               dict(kind="zero_serve", name="s4 qwen2-7b fsdp_tp(2, 2)",
                    forced=forced_tokens(refs["serve"]["greedy"], S_GEN,
                                         S_FORCED)),
               dict(kind="zero_train", what="whisper", shape=(2, 2),
                    strategy="fsdp_tp", name="t1 whisper-base fsdp_tp(2, 2)",
                    ref=str(tmp / "s_whisper.pt"))]}
    for js in jobs.values():  # each training layout's first with the fault
        firsts = {}
        for job in js:
            if job["kind"] == "zero_train":
                firsts.setdefault(job["what"], job)
        js += [dict(job, name=f"{job['name']} {S_FAULT}", fault=S_FAULT,
                    serve=False) for job in firsts.values()]
    print(f"(s) one-rank references "
          f"{ {k: round(v['s'], 1) for k, v in refs.items()} } s",
          flush=True)
    return jobs, refs


def check_zero(dev, ranks: dict, refs: dict) -> dict:
    """Phase (s)'s checks, every job's before any failure is raised;
    returns the launch counts by path."""
    paths, failed, readings = {}, [], {}
    for what in ("clf", "qwen", "mamba", "whisper"):
        twin = refs[what]["twin"]
        readings[f"{what} sound twin"] = twin
        print(f"(s) {what} sound twin (one rank, rows reversed) vs one "
              f"rank: {json.dumps(twin)}", flush=True)
        if s_broken(twin):
            failed.append(f"(s) {what} sound twin broke {s_broken(twin)}")
    for name, rs in ranks.items():
        try:
            readings[name] = check_zero_job(dev, name, rs, refs, paths)
        except AssertionError as e:
            failed.append(str(e))
    print(f"(s) bounds between the sound and the faulty readings: "
          f"{json.dumps(s_margins(readings))}", flush=True)
    if failed:
        raise AssertionError("\n".join(failed))
    return paths


def s_margins(readings: dict) -> dict:
    """For each bound of the s1-s3 checks: the largest reading of a sound
    run (each mesh layout, each twin), the bound, and the smallest reading
    of a run with S_FAULT planted."""
    keys = {"loss": (S_LOSS_RTOL, lambda r: r["loss_rel"][0]),
            "grad_norm": (S_GNORM_RTOL, lambda r: r["grad_norm_rel"][0]),
            "trajectory": (S_TRAJ_RTOL, lambda r: max(
                r["loss_rel"][1:] + r["grad_norm_rel"][1:], default=0.0)),
            "update": (S_UPDATE_RTOL, lambda r: r["update_rel_rms"]),
            "grads": (S_GRAD_RTOL, lambda r: r.get("grad_rel_rms"))}
    train = {n: r for n, r in readings.items()
             if r is not None and "loss_rel" in r}
    out = {}
    for key, (bound, read) in keys.items():
        sound = [read(r) for n, r in train.items()
                 if not n.endswith(S_FAULT) and read(r) is not None]
        faulty = [read(r) for n, r in train.items()
                  if n.endswith(S_FAULT) and read(r) is not None]
        out[key] = [max(sound, default=None), bound,
                    min(faulty, default=None)]
    return out


def check_zero_job(dev, name, rs, refs, paths):
    """One phase (s) job's checks; its launch counts into ``paths``."""
    what = name.split()[0]
    if what == "s4":
        out = check_zero_serve(dev, rs, refs["serve"])
        paths["zero_serve_qwen2_7b"] = {
            k: sum(x[m]["counts"][k] for x in rs
                   for m in ("greedy", "sampled"))
            for k in rs[0]["greedy"]["counts"]}
    else:
        key = {"s1": "clf", "s2": "qwen", "s3": "mamba",
               "t1": "whisper"}[what]
        out = check_zero_train(name, rs, refs[key])
        if "held_logits" in rs[0]:
            out.update(check_zero_clf(name, rs, refs[key],
                                      configs.get("distilbert-imdb")))
            paths["zero_classify_distilbert"] = {
                k: sum(x["serve_launches"][k] for x in rs)
                for k in rs[0]["serve_launches"]}
    out["job_s"] = rs[0]["job_s"]
    print(f"(s) {name}: {json.dumps(out, default=str)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase (t): SSM and encoder-decoder models under a mesh, and replicas on
# disjoint mesh slices, on (r)'s rank spawns
# ---------------------------------------------------------------------------

# t1: whisper-base at full width on (2, 2) "tp" (4 of its 8 heads a rank):
# 4 requests of 4-16 prompt tokens, each over its own 1 500 frames, 16 new
# tokens, 4 slots of 64; greedy, then fused sampled. Its training, 2 AdamW
# steps of 4 x 1 500 frames with 64-token targets under "fsdp_tp" (2, 2),
# rides phase (s)'s training jobs ("whisper": its reference, sound twin,
# planted fault and bounds).
T_WHISPER = dict(n_requests=4, prompt_len=(4, 17), new_tokens=(16, 17),
                 n_slots=4, max_len=64, frames=1500)
T_WHISPER_STEPS, T_WHISPER_BATCH = 2, (4, 64)
# t2: mamba2-130m, all 24 layers: 8 requests of 128 or 256 tokens (whole
# SSD chunks), 16 new, over 8 slots, on (1, 2) "tp" and (2, 2) "fsdp_tp"
T_MAMBA = dict(n_requests=8, prompt_lens=(128, 256), new_tokens=(16, 17),
               n_slots=8, max_len=512)
# t3: jamba at smoke width (the full model is about 400 B params), 8
# requests of one or two SSD chunks of its smoke config, on (1, 2) "tp"
T_JAMBA = dict(n_requests=8, prompt_lens=(8, 16), new_tokens=(16, 17),
               n_slots=4, max_len=64)
# (name, family, mesh, strategy, sampled) of t1-t3's served layouts
T_FAMILIES = [("t1 whisper-base tp(2, 2)", "whisper", (2, 2), "tp", True),
              ("t2 mamba2-130m tp(1, 2)", "mamba", (1, 2), "tp", False),
              ("t2 mamba2-130m fsdp_tp(2, 2)", "mamba", (2, 2), "fsdp_tp",
               False),
              ("t3 jamba smoke tp(1, 2)", "jamba", (1, 2), "tp", False)]
# t4: the paper's deployment, a replica per mesh slice: qwen2-7b, all 28
# layers, tamed q/k, (2, 2) cut into 2 slices of (1, 2) "tp"; 12 requests
# of 64-256 tokens, 16 new, 4 slots of 512 a replica, QueueDepthPolicy,
# all arriving at once, greedy; on the modeled clock, then the measured
T_SLICES = dict(n_requests=12, prompt_len=(64, 257), new_tokens=(16, 17),
                n_slots=4, max_len=512)
T_LAT = dict(cold_start_s=0.5, per_item_s=0.02)
# t4's command line, at the smoke config ``main`` serves
T_CLI_ARGV = ["--router", "--mesh", "2x2", "--mesh-slices", "2",
              "--horizon", "2", "--seed", str(SEED)]
# a greedy stream on a mesh may part from one rank's at near-ties only, and
# at most T_GREEDY_PARTS eighths of the streams; a sampled one (t1) at most
# R_SAMPLED_PARTS of R_GEN's 8. The random full-width mamba2-130m's logits
# are flat (its best logits lie within the near-tie bound of each other
# often: 5 of 8 streams parted at near-ties on (2, 2) on an H100,
# PERF.md §6, each judged), so its streams may part at near-ties in up to
# T_FLAT_PARTS eighths. The smoke jamba's init is
# chaotic (its own half-ulp param shift moves its logits by 58-123% RMS:
# tests/test_torch_families.py), so its streams part wherever the mesh's
# summation order flips a token: t3 holds its admission logits and counts
# its partings, as that test does for the smoke jamba
T_GREEDY_PARTS, T_FLAT_PARTS = 3, 6
T_CHAOTIC = ("jamba",)


def t_config(family: str):
    """The config of a t1-t3 family (``R_CONFIG``: full width; jamba at
    smoke width)."""
    if family == "jamba":
        return configs.smoke("jamba-1.5-large-398b")
    return R_CONFIG({"whisper": "whisper-base",
                     "mamba": "mamba2-130m"}[family])


def t_gen(family: str) -> dict:
    return {"whisper": T_WHISPER, "mamba": T_MAMBA, "jamba": T_JAMBA}[family]


def t_requests(cfg, gen) -> list:
    """``gen``'s requests, drawn from SEED: prompts of ``prompt_len``
    (a range) or ``prompt_lens`` (a choice), an encoder-decoder model's
    frame embeddings with each."""
    rng = np.random.default_rng(SEED)
    reqs = []
    for rid in range(gen["n_requests"]):
        n = (int(rng.choice(gen["prompt_lens"])) if "prompt_lens" in gen
             else int(rng.integers(*gen["prompt_len"])))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        frames = (rng.standard_normal((gen["frames"], cfg.enc_d_model),
                                      dtype=np.float32)
                  if cfg.encdec else None)
        reqs.append(Request(rid, prompt, max_new_tokens=int(
            rng.integers(*gen["new_tokens"])), enc_embeds=frames))
    return reqs


def t_init(model, dev, shardings=None):
    """Params drawn from SEED (this rank's slices with ``shardings``),
    q/k tamed as phases (q) and (r) tame them."""
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev,
                        shardings=shardings)
    if model.cfg.encdec:
        tame_whisper(model.cfg, params)
    else:
        tame_attention(model.cfg, params)
    return params


def t_serve(engine, params, cfg, gen, **kw) -> dict:
    """``gen``'s requests through ``ContinuousBatcher``, the launch counts
    around them."""
    reqs = t_requests(cfg, gen)
    torch.cuda.synchronize()
    reset_counts()
    res = serve_cluster.serve(engine, params, reqs, n_slots=gen["n_slots"],
                              max_len=gen["max_len"], seed=SEED, **kw)
    torch.cuda.synchronize()
    b = res["batcher"]
    if b.take_rejected() or len(res["completed"]) != len(reqs):
        raise AssertionError("(t) requests rejected or left undone")
    return {"streams": [r.generated for r in reqs], "counts": read_counts(),
            "rounds": b.rounds, "wall_s": res["wall_s"],
            "tokens": res["tokens"]}


def t_admissions(engine, params, cfg, gen) -> torch.Tensor:
    """Each request's last-prompt-token logits, prefilled alone."""
    out = []
    with torch.no_grad():
        for r in t_requests(cfg, gen):
            kw = ({} if r.enc_embeds is None
                  else {"enc_embeds": r.enc_embeds[None]})
            out.append(engine.prefill(params, r.prompt[None],
                                      max_len=gen["max_len"], **kw)[0])
    return torch.cat(out).float().cpu()


def t_family_run(dev, family, mesh=None, strategy=None,
                 sampled=False) -> dict:
    """A t1-t3 family served on ``mesh`` (this rank's part) or on one
    rank: admission logits, greedy (and fused-sampled) streams with their
    launch counts and collectives, param bytes against the planner's."""
    cfg, gen = t_config(family), t_gen(family)
    model = build_model(cfg)
    engine = Engine(model, serve_cluster.RUN, device=dev, mesh=mesh,
                    strategy=strategy)
    params = t_init(model, dev, engine.params_sharding)
    torch.cuda.synchronize()
    out = {"admission_logits": t_admissions(engine, params, cfg, gen),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    if mesh is not None:
        out["planned_bytes"] = planned_bytes(model, engine)
        out["strategy"] = engine.strategy
    collectives.reset_stats()
    out["greedy"] = t_serve(engine, params, cfg, gen)
    out["collectives"] = {k: v[0] for k, v in collectives.STATS.items()}
    if sampled:
        out["sampled"] = t_serve(engine, params, cfg, gen,
                                 fused_sampling=True,
                                 **serve_cluster.SAMPLING)
    if mesh is None:  # kept to judge where a mesh's stream parts
        out["judge"] = (engine, params)
    else:
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def t_family_job(dev, job, rank) -> dict:
    mesh = make_host_mesh(tuple(job["shape"]))
    return t_family_run(dev, job["family"], mesh, job["strategy"],
                        job.get("sampled", False))


def t_parted(engine, params, reqs, want, got, tie) -> int:
    """Greedy streams equal, or parted where both tokens lie within
    ``tie`` of the best logit of one rank's forward pass over the prompt
    (and frames) and the common tokens at the first difference; raises at
    a parting that is not a near-tie. Returns how many parted."""
    parted = 0
    for r, a, b in zip(reqs, want, got):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        seq = np.concatenate([r.prompt, a[:i]]).astype(np.int32)
        batch = {"tokens": torch.tensor(seq[None], device=engine.device)}
        if r.enc_embeds is not None:
            batch["enc_embeds"] = torch.tensor(
                r.enc_embeds[None], device=engine.device)
        with torch.no_grad():
            logits = engine.model.forward(engine.run, params,
                                          batch)[0][0, -1].float()
        best = float(logits.max())
        gaps = (best - float(logits[a[i]]), best - float(logits[b[i]]))
        if max(gaps) > tie:
            raise AssertionError(f"(t) stream parts at token {i} ({a[i]} "
                                 f"vs {b[i]}) with logit gaps {gaps} > "
                                 f"{tie}")
        parted += 1
    return parted


def t_check_family(name, family, ranks, ref) -> dict:
    """One t1-t3 layout held to one rank: streams equal on every rank;
    admission logits within PATH_RTOL; greedy streams parted only at
    near-ties (at most T_GREEDY_PARTS), sampled at most R_SAMPLED_PARTS;
    every rank's param bytes the planner's; the attention kernels (none
    for mamba2) and, sampled, the sampling kernel launched on every
    rank."""
    cfg, gen = t_config(family), t_gen(family)
    res = ranks[0]
    for mode in ("greedy", "sampled"):
        if mode in res and any(x[mode]["streams"] != res[mode]["streams"]
                               for x in ranks[1:]):
            raise AssertionError(f"(t) {name}: ranks' {mode} streams "
                                 f"differ")
    err = rel_rms(res["admission_logits"], ref["admission_logits"])
    diff = float((res["admission_logits"]
                  - ref["admission_logits"]).abs().max())
    tie = NOISE_FACTOR * diff + LOGIT_FLOOR
    if not torch.isfinite(res["admission_logits"]).all() or err > PATH_RTOL:
        raise AssertionError(f"(t) {name}: admission logits vs one rank, "
                             f"relative RMS {err}")
    engine, params = ref["judge"]
    params = tree_map(lambda t: t.to(engine.device), params)
    reqs = t_requests(cfg, gen)
    if family in T_CHAOTIC:
        greedy = sum(a != b for a, b in zip(ref["greedy"]["streams"],
                                            res["greedy"]["streams"]))
    else:
        greedy = t_parted(engine, params, reqs, ref["greedy"]["streams"],
                          res["greedy"]["streams"], tie)
        parts = T_FLAT_PARTS if family == "mamba" else T_GREEDY_PARTS
        if greedy > parts * len(reqs) // 8:
            raise AssertionError(f"(t) {name}: {greedy} greedy streams "
                                 f"parted")
    out = {"strategy": res["strategy"], "admission_rel_rms": err,
           "max_abs_diff": diff, "near_tie_bound": tie,
           "greedy_parted": greedy, "rounds": res["greedy"]["rounds"],
           "greedy_tokens_per_s": res["greedy"]["tokens"]
           / res["greedy"]["wall_s"],
           "one_rank_tokens_per_s": ref["greedy"]["tokens"]
           / ref["greedy"]["wall_s"],
           "param_bytes_per_rank": res["param_bytes"],
           "one_rank_param_bytes": ref["param_bytes"],
           "collectives_rank0": res["collectives"],
           "launches_rank0": res["greedy"]["counts"]}
    if "sampled" in res:
        parted = sum(a != b for a, b in zip(ref["sampled"]["streams"],
                                            res["sampled"]["streams"]))
        if parted > R_SAMPLED_PARTS * len(reqs) // R_GEN["n_requests"]:
            raise AssertionError(f"(t) {name}: {parted} sampled streams "
                                 f"parted from one rank's")
        out["sampled_parted"] = parted
    attn = cfg.has_mixer("attn")
    for r, x in enumerate(ranks):
        if x["param_bytes"] != x["planned_bytes"]:
            raise AssertionError(f"(t) {name} rank {r}: {x['param_bytes']} "
                                 f"param bytes, planned {x['planned_bytes']}")
        c = x["greedy"]["counts"]
        if (c["flash_attention"] > 0) != attn or \
                (c["decode_attention"] > 0) != attn:
            raise AssertionError(f"(t) {name} rank {r}: launches {c}")
        if "sampled" in x and x["sampled"]["counts"]["fused_sample"] == 0:
            raise AssertionError(f"(t) {name} rank {r}: no sampling kernel")
    print(f"(t) {name}: {json.dumps(out)}", flush=True)
    return out


def t_slice_requests(cfg) -> list:
    reqs = serve_cluster.make_requests(
        cfg.vocab_size, T_SLICES["n_requests"], T_SLICES["prompt_len"],
        T_SLICES["new_tokens"], SEED)
    for r in reqs:
        r.arrival_t = 0.0
    return reqs


def t_slices_reference(dev) -> dict:
    """t4's requests through one rank's batcher (4 slots of 512) on the
    same tamed params: the greedy streams the slices are held to."""
    cfg = R_CONFIG("qwen2-7b")
    model = build_model(cfg)
    engine = Engine(model, serve_cluster.RUN, device=dev)
    params = r_init(model, dev)
    reqs = t_slice_requests(cfg)
    serve_cluster.serve(engine, params, reqs, n_slots=T_SLICES["n_slots"],
                        max_len=T_SLICES["max_len"], seed=SEED)
    out = {"streams": [r.generated for r in reqs]}
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def t_slices_job(dev, job, rank) -> dict:
    """t4 on this rank: a ``Router`` over ``ReplicaPool(mesh_slices=2)``
    on the (2, 2) mesh, each slice's engine drawing its (1, 2) "tp"
    shards; on the modeled clock, then the measured one. Per run: the
    report, the streams, each replica's slice, whether this rank computed
    it and its rounds, the launch counts and the router's wall time; the
    slice's param bytes against the planner's and ``memory_allocated``."""
    cfg = R_CONFIG("qwen2-7b")
    model = build_model(cfg)
    mesh = make_host_mesh((2, 2))
    engine = Engine(model, serve_cluster.RUN, device=dev, mesh=mesh,
                    strategy="tp")
    out = {}
    step = Replica.step
    for clock in ("modeled", "measured"):
        lat = dict(T_LAT, per_item_s=None) if clock == "measured" else T_LAT
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        pool = ReplicaPool(engine, lambda e: r_init(model, dev,
                                                    e.params_sharding),
                           ReplicaConfig(n_slots=T_SLICES["n_slots"],
                                         max_len=T_SLICES["max_len"]),
                           lat=LatencyModel(**lat), mesh_slices=2)
        # this rank's slice built before the run: its params alone
        mine = next(i for i in range(2) if pool.slices.member(i))
        eng, params = pool.slices.engine_for(mine)
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated(dev) - mem0
        reqs = t_slice_requests(cfg)
        router = Router(pool, QueueDepthPolicy(max_replicas=8), reqs,
                        traffic_name="t4")
        busy = {}  # replica -> host seconds of the rounds this rank ran

        def timed(r):
            t = time.perf_counter()
            s = step(r)
            if r.computes:
                torch.cuda.synchronize()
                busy[r.replica_id] = busy.get(r.replica_id, 0.0) + (
                    time.perf_counter() - t)
            return s
        Replica.step = timed
        reset_counts()
        t0 = time.perf_counter()
        try:
            rep = router.run()
        finally:
            Replica.step = step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[clock] = {
            "summary": rep.summary(), "wall_s": wall,
            "streams": [r.generated for r in reqs],
            "counts": read_counts(), "held": pool.slices.held(),
            "replicas": [(r.slice_idx, r.computes, r.rounds, r.spawn_t,
                          r.retire_t) for r in pool.replicas],
            "busy_s": sum(busy.values()),
            "slice_devices": [pool.slices.devices_of(i) for i in range(2)],
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(params)),
            "planned_bytes": planned_bytes(model, eng),
            "slice_shape": dict(eng.mesh.shape),
            "memory_allocated": mem,
            "compile_count": pool.slices.compile_count()}
        del pool, router, eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def t_cli_job(dev, job, rank) -> dict:
    """t4's command line as a user types it, run as one of its ranks:
    ``launch.serve.main`` with ``--router --mesh 2x2 --mesh-slices 2`` at
    the smoke config it serves, every policy; the launch counts."""
    torch.cuda.synchronize()
    reset_counts()
    out = serve.main(list(job["argv"]))
    torch.cuda.synchronize()
    return {"summaries": out, "counts": read_counts()}


def t_check_slices(dev, ranks, ref, tie) -> dict:
    """t4 held: the report and streams equal on every rank, on each
    clock; every request done, 2 slices, at most 2 replicas live; each
    rank computed only its slice's replicas and both slices served; the
    slices' lifetimes disjoint; no slice held at the end; the modeled
    run's greedy streams parted from one rank's batcher only at
    near-ties (``tie``: phase (r)'s bound on (1, 2), the slice's own
    layout); the param bytes a rank the planner's and within S_MEM_RTOL of
    ``memory_allocated``; the flash and decode kernels launched on every
    rank."""
    cfg = R_CONFIG("qwen2-7b")
    out = {}
    for clock in ("modeled", "measured"):
        res = [x[clock] for x in ranks]
        first = res[0]
        for x in res[1:]:
            if x["summary"] != first["summary"] or \
                    x["streams"] != first["streams"]:
                raise AssertionError(f"(t) t4 {clock}: ranks' reports or "
                                     f"streams differ")
        s = first["summary"]
        if s["n_completed"] != T_SLICES["n_requests"] or \
                s["n_slices"] != 2 or s["peak_replicas"] > 2:
            raise AssertionError(f"(t) t4 {clock}: {s}")
        spans = {}
        for rank, x in enumerate(res):
            slice_of = next(i for i, d in enumerate(x["slice_devices"])
                            if rank in d)
            for idx, computes, _, start, end in x["replicas"]:
                if computes != (idx == slice_of):
                    raise AssertionError(f"(t) t4 rank {rank} computed "
                                         f"slice {idx}: {computes}")
            if x["held"]:
                raise AssertionError(f"(t) t4: slices {x['held']} held")
            if x["param_bytes"] != x["planned_bytes"] or abs(
                    x["memory_allocated"] - x["param_bytes"]) > \
                    S_MEM_RTOL * x["param_bytes"]:
                raise AssertionError(
                    f"(t) t4 rank {rank}: {x['param_bytes']} param bytes, "
                    f"planned {x['planned_bytes']}, allocated "
                    f"{x['memory_allocated']}")
            if not (x["counts"]["flash_attention"]
                    and x["counts"]["decode_attention"]):
                raise AssertionError(f"(t) t4 rank {rank}: launches "
                                     f"{x['counts']}")
        for idx, _, _, start, end in first["replicas"]:
            spans.setdefault(idx, []).append(
                (start, float("inf") if end is None else end))
        if set(spans) != {0, 1}:
            raise AssertionError(f"(t) t4 {clock}: slices used {spans}")
        for sp in spans.values():
            sp.sort()
            if any(e0 > s1 + 1e-9 for (_, e0), (s1, _) in zip(sp, sp[1:])):
                raise AssertionError(f"(t) t4: a slice held twice {sp}")
        # a slice's rounds and the host seconds its first rank spent in
        # them; concurrency: the two slices' busy seconds over the wall
        by_slice = {i: x for i, x in ((0, res[0]), (1, res[2]))}
        rounds = {i: sum(r for idx, c, r, _, _ in x["replicas"]
                         if c and idx == i) for i, x in by_slice.items()}
        busy = {i: x["busy_s"] for i, x in by_slice.items()}
        out[clock] = {"summary": s, "wall_s_per_rank": [x["wall_s"]
                                                        for x in res],
                      "rounds_by_slice": rounds, "busy_s_by_slice": busy,
                      "ms_per_round_by_slice": {
                          i: 1e3 * busy[i] / max(rounds[i], 1)
                          for i in busy},
                      "concurrency": sum(busy.values()) / first["wall_s"],
                      "launches_rank0": first["counts"]}
    modeled = ranks[0]["modeled"]
    prompts = [r.prompt for r in t_slice_requests(cfg)]
    out["greedy_parted"] = judge_greedy(dev, cfg, prompts, ref["streams"],
                                        modeled["streams"], tie)
    if out["greedy_parted"] > T_GREEDY_PARTS * T_SLICES["n_requests"] // 8:
        raise AssertionError(f"(t) t4: {out['greedy_parted']} streams "
                             f"parted")
    out["measured_parted"] = sum(
        a != b for a, b in zip(ranks[0]["measured"]["streams"],
                               modeled["streams"]))
    out.update(param_bytes_per_rank=modeled["param_bytes"],
               memory_allocated_per_rank=[x["modeled"]["memory_allocated"]
                                          for x in ranks],
               slice_shape=modeled["slice_shape"],
               compile_count_rank0=modeled["compile_count"])
    print(f"(t) t4 qwen2-7b on 2 slices of (1, 2): {json.dumps(out)}",
          flush=True)
    return out


def t_check_cli(ranks) -> dict:
    """t4's command line: every policy's summary equal on every rank, each
    request done, 2 slices; the kernels launched on every rank."""
    first = ranks[0]["summaries"]
    for x in ranks[1:]:
        if x["summaries"] != first:
            raise AssertionError("(t) t4 command line: ranks' summaries "
                                 "differ")
    for name, s in first.items():
        if s["n_completed"] != s["n_submitted"] or s["n_slices"] != 2 \
                or s["peak_replicas"] > 2:
            raise AssertionError(f"(t) t4 command line {name}: {s}")
    for r, x in enumerate(ranks):
        if not (x["counts"]["flash_attention"]
                and x["counts"]["decode_attention"]):
            raise AssertionError(f"(t) t4 command line rank {r}: "
                                 f"{x['counts']}")
    out = {name: {k: s[k] for k in ("n_completed", "peak_replicas",
                                     "ttft_p50_s", "tpot_p50_s")}
           for name, s in first.items()}
    print(f"(t) t4 launch.serve --router --mesh 2x2 --mesh-slices 2: "
          f"{json.dumps(out)}", flush=True)
    return out


def t_jobs(dev) -> tuple:
    """Phase (t)'s jobs for the 2- and 4-rank spawns and its one-rank
    references (computed here, before the spawns)."""
    t0 = time.perf_counter()
    refs = {family: t_family_run(dev, family, sampled=family == "whisper")
            for family in ("whisper", "mamba", "jamba")}
    refs["slices"] = t_slices_reference(dev)
    for family in ("whisper", "mamba", "jamba"):
        # the judges' params wait on the host while the ranks run: the
        # 4-rank spawn's ZeRO training peaks at 19 GB a rank, and the card
        # had 0.4 GB left for the parent's 1 GB of judges (PERF.md §6)
        engine, params = refs[family]["judge"]
        refs[family]["judge"] = (engine, tree_map(lambda t: t.cpu(), params))
    gc.collect()
    torch.cuda.empty_cache()
    jobs = {2: [], 4: []}
    for name, family, shape, strategy, sampled in T_FAMILIES:
        jobs[shape[0] * shape[1]].append(dict(
            kind="t_family", name=name, family=family, shape=shape,
            strategy=strategy, sampled=sampled))
    jobs[4] += [dict(kind="t_slices", name="t4 slices"),
                dict(kind="t_cli", name="t4 command line",
                     argv=T_CLI_ARGV)]
    print(f"(t) one-rank references {time.perf_counter() - t0:.1f} s",
          flush=True)
    return jobs, refs


def check_t(dev, ranks: dict, refs: dict, tie: float) -> dict:
    """Phase (t)'s checks, every job's before any failure is raised;
    returns the launch counts by path, summed over the ranks."""
    paths, failed = {}, []
    for name, family, _, _, _ in T_FAMILIES:
        try:
            t_check_family(name, family, ranks[name], refs[family])
        except AssertionError as e:
            failed.append(str(e))
        paths["t_" + re.sub(r"\W+", "_", name.split(" ", 1)[1]).strip(
            "_")] = {
            k: sum(x[m]["counts"][k] for x in ranks[name]
                   for m in ("greedy", "sampled") if m in x)
            for k in NO_LAUNCHES}
    try:
        t_check_slices(dev, ranks["t4 slices"], refs["slices"], tie)
    except AssertionError as e:
        failed.append(str(e))
    paths["t_slices_qwen2_7b"] = {
        k: sum(x[c]["counts"][k] for x in ranks["t4 slices"]
               for c in ("modeled", "measured")) for k in NO_LAUNCHES}
    try:
        t_check_cli(ranks["t4 command line"])
    except AssertionError as e:
        failed.append(str(e))
    paths["t_serve_main_mesh_slices"] = {
        k: sum(x["counts"][k] for x in ranks["t4 command line"])
        for k in NO_LAUNCHES}
    for family in ("whisper", "mamba", "jamba"):
        refs[family].pop("judge", None)
    if failed:
        raise AssertionError("\n".join(failed))
    return paths


# ---------------------------------------------------------------------------
# Phase (u): the front door on a multi-rank mesh, rows over two data axes,
# the training CLI per family and the compile-only dry run
# ---------------------------------------------------------------------------

# (u1): qwen2-7b, all 28 layers, tamed q/k, through ``launch.serve.run_http``
# on (r)'s four ranks as a (2, 2) "tp" mesh: rank 0 binds the port and ticks
# every rank's router; U_HTTP's clients post prompts of 64-256 tokens for 16
# new tokens each, greedy, then fused sampled; the greedy streams are held
# to one rank's front door on the same params
U_HTTP = dict(n_clients=6, prompt_len=(64, 257), new_tokens=16)
U_HTTP_TIMEOUT_S = 120.0   # a pass takes about 10 s
U_ROUTER = dict(prompt_len=256, max_new_tokens=16, n_slots=4,
                max_replicas=2)
# then ``launch.serve --http --mesh 2x2`` as a user types it, at the smoke
# config ``main`` serves, for U_CLI_SERVE_S seconds with one client (the
# port is added when it runs)
U_CLI_SERVE_S = 3.0
U_CLI_ARGV = ["--http", "--mesh", "2x2", "--serve-seconds",
              str(U_CLI_SERVE_S), "--seed", str(SEED)]
# (u2): qwen2-7b at R_M4_LAYERS of 28 layers, tamed, on a ("pod", "data",
# "model") (2, 2, 1) mesh of the same ranks: r2's requests, their rows cut
# over "pod" x "data", held to (r)'s one-rank reference at that depth
U_ROWS = (2, 2, 1)
U_AXES = ("pod", "data", "model")
U_ROWS_NAME = f"u2 qwen{U_ROWS} pod x data"
# (u4): the compile-only dry run, started before phase (q) (it needs only
# the host's CPU): one rank of the production mesh traced on fake tensors
U_DRYRUNS = {
    "qwen2-7b train_4k (16, 16)": ["--arch", "qwen2-7b", "--shape",
                                   "train_4k"],
    "mamba2-130m train_4k (2, 16, 16)": ["--arch", "mamba2-130m",
                                         "--shape", "train_4k",
                                         "--multi-pod", "on"],
}
U_DRYRUN_TIMEOUT_S = 900


def u_prompts(cfg) -> list:
    return [r.prompt for r in serve_cluster.make_requests(
        cfg.vocab_size, U_HTTP["n_clients"], U_HTTP["prompt_len"],
        (U_HTTP["new_tokens"], U_HTTP["new_tokens"] + 1), SEED)]


def u_front_door(engine, params, cfg, **kw) -> dict:
    """U_HTTP's clients through ``launch.serve.run_http`` on ``engine``
    (this rank's part of its mesh): the report, the streams (where this
    rank ran the clients: rank 0), the launch counts, the admissions and
    the decode rounds."""
    prompts, n_new = u_prompts(cfg), U_HTTP["new_tokens"]

    async def clients(port):
        return await asyncio.wait_for(asyncio.gather(
            *(http_generate(port, p, n_new) for p in prompts)),
            U_HTTP_TIMEOUT_S)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = serve.run_http(cfg, engine=engine, params=params, seed=SEED,
                         port=0, clients=clients, **U_ROUTER, **kw)
    torch.cuda.synchronize()
    router = out["router"]
    res = {"report": out["report"], "port": out["port"],
           "counts": read_counts(), "wall_s": time.perf_counter() - t0,
           "admitted": int(router.obs.m_admitted.value()),
           "decode_rounds": sum(r.batcher.decode_dispatches
                                for r in router.pool.replicas)}
    if out["clients"] is not None:
        res["streams"] = []
        for p, chunks in zip(prompts, out["clients"]):
            toks, end = chunks[:-1], chunks[-1]
            if (end.get("event") != "end" or not end["done"]
                    or len(toks) != n_new):
                raise AssertionError(f"(u1) client: {chunks[-2:]}")
            res["streams"].append([c["token"] for c in toks])
    return res


def u_http_job(dev, job, rank) -> dict:
    """(u1) on this rank: the (2, 2) "tp" engine, params drawn one rank at
    a time (as r2's), the front door greedy then fused sampled."""
    cfg = R_CONFIG("qwen2-7b")
    model = build_model(cfg)
    engine = Engine(model, serve_cluster.RUN, device=dev,
                    mesh=make_host_mesh((2, 2)), strategy="tp")
    for r in range(4):
        if r == rank:
            params = r_init(model, dev, engine.params_sharding)
            torch.cuda.synchronize()
        torch.distributed.barrier()
    out = {"greedy": u_front_door(engine, params, cfg),
           "sampled": u_front_door(engine, params, cfg, fused_sampling=True,
                                   sampling=serve_cluster.SAMPLING)}
    del params, engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def u_jobs(dev) -> tuple:
    """Phase (u)'s jobs for the 4-rank spawn and (u1)'s one-rank reference
    (the front door on one rank, greedy), computed here first; (u2) is
    held to (r)'s one-rank reference at R_M4_LAYERS."""
    t0 = time.perf_counter()
    cfg = R_CONFIG("qwen2-7b")
    model = build_model(cfg)
    engine = Engine(model, serve_cluster.RUN, device=dev)
    ref = u_front_door(engine, r_init(model, dev), cfg)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    jobs = [dict(kind="u_http", name="u1 front door tp(2, 2)")]
    print(f"(u) one-rank front door {time.perf_counter() - t0:.1f} s",
          flush=True)
    return jobs, ref


def u_check_http(dev, ranks, ref, tie) -> dict:
    """(u1) held: each pass's report equal on every rank and only rank 0
    bound; every client served; on every rank the decode kernel once a
    layer a round and (sampled) the sampling kernel, over the data ranks of
    one model line the flash kernel once a layer an admission; the greedy
    streams parted from one rank's front door only at near-ties
    (``tie``: phase (r)'s bound on (2, 2))."""
    cfg = R_CONFIG("qwen2-7b")
    prompts = u_prompts(cfg)
    out = {}
    for mode in ("greedy", "sampled"):
        res = [x[mode] for x in ranks]
        first = res[0]
        if any(x["report"] != first["report"] for x in res[1:]):
            raise AssertionError(f"(u1) {mode}: ranks' reports differ")
        if [x["port"] is None for x in res] != [False, True, True, True]:
            raise AssertionError(f"(u1) {mode}: ports {[x['port'] for x in res]}")
        rep = first["report"]
        if rep["n_completed"] != len(prompts) or \
                len(first["streams"]) != len(prompts):
            raise AssertionError(f"(u1) {mode}: {rep}")
        for r, x in enumerate(res):
            c = x["counts"]
            if c["decode_attention"] != cfg.n_layers * x["decode_rounds"] \
                    or (mode == "sampled") != (c["fused_sample"] > 0):
                raise AssertionError(f"(u1) {mode} rank {r}: launches {c}, "
                                     f"{x['decode_rounds']} rounds")
        flash = sum(res[r]["counts"]["flash_attention"] for r in (0, 2))
        if flash != cfg.n_layers * first["admitted"]:
            raise AssertionError(f"(u1) {mode}: flash {flash} over ranks 0 "
                                 f"and 2, {first['admitted']} admissions")
        out[mode] = {k: rep[k] for k in (
            "ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "wall_time_s",
            "peak_replicas", "tokens_out", "tokens_per_s")}
        out[mode].update(admitted=first["admitted"],
                         decode_rounds=first["decode_rounds"],
                         launches_per_rank=[x["counts"] for x in res])
    out["greedy_parted"] = judge_greedy(dev, cfg, prompts, ref["streams"],
                                        ranks[0]["greedy"]["streams"], tie)
    if out["greedy_parted"] > T_GREEDY_PARTS * len(prompts) // 8:
        raise AssertionError(f"(u1) {out['greedy_parted']} greedy streams "
                             f"parted")
    out["one_rank"] = {k: ref["report"][k] for k in (
        "ttft_p50_s", "ttft_p99_s", "wall_time_s", "tokens_per_s")}
    print(f"(u1) the front door on (2, 2) tp, qwen2-7b 28 layers, "
          f"{len(prompts)} clients on {card_line()}: {json.dumps(out)}",
          flush=True)
    return out


def check_u(dev, ranks: dict, ref: dict, qref: dict, tie: float) -> dict:
    """(u1) and (u2)'s checks; returns their launch counts by path, summed
    over the ranks."""
    u1 = ranks["u1 front door tp(2, 2)"]
    u_check_http(dev, u1, ref, tie)
    out = check_lm_layout(dev, U_ROWS_NAME, dataclasses.replace(
        R_CONFIG("qwen2-7b"), n_layers=R_M4_LAYERS), ranks[U_ROWS_NAME],
        qref)
    rows = R_GEN["n_slots"] // int(np.prod(U_ROWS[:-1]))
    if out["cache_block"][0] != rows:
        raise AssertionError(f"(u2) cache block {out['cache_block']}: rows "
                             f"not cut over pod x data")
    return {"u_http_qwen2_7b": {k: sum(x[m]["counts"][k] for x in u1
                                       for m in ("greedy", "sampled"))
                                for k in NO_LAUNCHES},
            "u_rows_qwen2_7b": {k: sum(x["greedy"]["counts"][k]
                                       for x in ranks[U_ROWS_NAME])
                                for k in NO_LAUNCHES}}


def u_cli(dev) -> dict:
    """(u1)'s command line as a user types it: ``launch.serve --http
    --mesh 2x2`` (four ranks on the card) served U_CLI_SERVE_S seconds
    from a thread while one client here posts to rank 0's port; every
    rank's report the same, only rank 0 bound."""
    port, box = free_port(), {}
    argv = U_CLI_ARGV + ["--port", str(port)]
    path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([path] if path else []))

    def serve_http():
        try:
            box["out"] = serve.main(argv, rank_timeout=R_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["error"] = e

    async def client():
        deadline = time.monotonic() + R_TIMEOUT_S
        while True:  # the ranks start, then rank 0 binds
            try:
                return await asyncio.wait_for(
                    http_generate(port, list(range(1, 17)), 8), 60)
            except OSError:
                if time.monotonic() > deadline or not server.is_alive():
                    raise
                await asyncio.sleep(0.2)

    t0 = time.perf_counter()
    server = threading.Thread(target=serve_http)
    server.start()
    try:
        chunks = asyncio.run(client())
    finally:
        server.join(R_TIMEOUT_S)
        if path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = path
    if server.is_alive():
        raise AssertionError("(u1) --http --mesh 2x2 still serving")
    if "error" in box:
        raise box["error"]
    out = box["out"]
    rep = out["report"]
    if out["port"] != port or [r["port"] for r in out["ranks"]] != [
            port, None, None, None] or any(
            r["report"] != rep for r in out["ranks"]) or \
            rep["n_completed"] != 1 or len(chunks) != 9:
        raise AssertionError(f"(u1) --http --mesh 2x2: {out}")
    res = {"wall_s": time.perf_counter() - t0, "ttft_p50_s":
           rep["ttft_p50_s"], "tokens_out": rep["tokens_out"]}
    print(f"(u1) launch.serve --http --mesh 2x2 --port {port} on "
          f"{card_line()}: one client, every rank's report the same, only "
          f"rank 0 bound; {json.dumps(res)}", flush=True)
    return res


def start_dryruns() -> dict:
    """Start (u4)'s ``python -m repro_torch.launch.dryrun`` cells as a user
    runs them, with the card in sight: CPU processes beside the phases."""
    out = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         str(out)], cwd=str(ROOT), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, argv in U_DRYRUNS.items()}
    return {"out": out, "procs": procs, "t0": time.perf_counter()}


def stop_processes(procs):
    """Kill whichever of ``procs`` still runs (a failed phase's exit)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_dryruns(run: dict) -> dict:
    """Wait for :func:`start_dryruns`' cells: each exits 0 and writes a
    record with status "ok", the card never initialised in its process."""
    procs, res = run["procs"], {}
    try:
        for name, p in procs.items():
            left = max(U_DRYRUN_TIMEOUT_S - (time.perf_counter() - run["t0"]),
                       1)
            out, err = p.communicate(timeout=left)
            if p.returncode:
                raise AssertionError(f"(u4) dry run {name} exited "
                                     f"{p.returncode}:\n{err[-3000:]}")
            argv = U_DRYRUNS[name]
            pod = "pod2" if "--multi-pod" in argv else "pod1"
            rec = json.loads(Path(run["out"], f"{argv[1]}__{argv[3]}__"
                                              f"{pod}.json").read_text())
            if rec["status"] != "ok" or rec["cuda_initialized"]:
                raise AssertionError(f"(u4) {name}: {rec.get('error')}, "
                                     f"CUDA {rec['cuda_initialized']}")
            r = rec["roofline"]
            res[name] = {"trace_s": rec["trace_s"],
                         "strategy": rec["strategy"],
                         "flops_per_chip": rec["ops"]["flops_per_chip"],
                         "model_flops_per_chip": r["model_flops_per_chip"],
                         "flops_over_model": rec["ops"]["flops_per_chip"]
                         / r["model_flops_per_chip"],
                         "peak_live_bytes": rec["memory"]["peak_live_bytes"],
                         "dominant": r["dominant"]}
    finally:
        stop_processes(procs.values())
    res["wall_s"] = time.perf_counter() - run["t0"]
    print(f"(u4) launch.dryrun on the card's host, the card untouched: "
          f"{json.dumps(res)}", flush=True)
    return res


def run_u_tail(dev, dry: dict) -> dict:
    """Phase (u)'s parts outside (r)'s spawns: (u1)'s command line and
    (u4)'s dry runs."""
    torch.cuda.empty_cache()
    cli = u_cli(dev)
    return {"cli": cli, "dryrun": finish_dryruns(dry)}


def run_tp(dev) -> dict:
    """Phases (r) and (s) on one pair of rank spawns sharing the card
    (gloo): (r) tensor-parallel params and a data axis, (s) the ZeRO-3
    layouts, training and serving; each layout held to one rank on the
    same (tamed) params and inputs. Returns the ranks' launch counts by
    run, summed over ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        return _run_tp(dev, Path(tmp))


def _run_tp(dev, tmp: Path) -> dict:
    torch.cuda.empty_cache()
    qcfg = R_CONFIG("qwen2-7b")
    t_s = time.perf_counter()
    zero, zero_refs = zero_jobs(dev, tmp)
    s_ref_s = time.perf_counter() - t_s
    t_t = time.perf_counter()
    tjobs, t_refs = t_jobs(dev)
    t_ref_s = time.perf_counter() - t_t
    t_u = time.perf_counter()
    ujobs, u_ref = u_jobs(dev)
    u_ref_s = time.perf_counter() - t_u
    t0 = time.perf_counter()
    qcfg4 = dataclasses.replace(qcfg, n_layers=R_M4_LAYERS)
    refs = {"qwen": one_rank_lm(dev, qcfg, sampled=True),
            "qwen(1, 4)": one_rank_lm(dev, qcfg4),
            "moe(2, 1)": one_rank_lm(dev, moe_config(False),
                                     prefill=R_MOE_PREFILL, halves=True),
            "moe(1, 2)": one_rank_lm(dev, moe_config(True),
                                     prefill=R_MOE_PREFILL)}
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    qf = forced_tokens(refs["qwen"]["greedy"])
    jobs = {2: [dict(kind="lm", arch="qwen2-7b", shape=s, name=f"qwen{s}",
                     sampled=refs["qwen"]["sampled"]["streams"],
                     forced=qf) for s in R_SAMPLED]
            + [dict(kind="lm", arch="moe", shape=(2, 1), name="moe(2, 1)",
                    prefill=R_MOE_PREFILL,
                    forced=forced_tokens(refs["moe(2, 1)"]["greedy"])),
               dict(kind="lm", arch="moe", shape=(1, 2), name="moe(1, 2)",
                    prefill=R_MOE_PREFILL, no_drops=True,
                    forced=forced_tokens(refs["moe(1, 2)"]["greedy"]))],
            4: [dict(kind="clf", name="distilbert(2, 2)", argv=R_CLF_ARGV)]
            + [dict(kind="lm", arch="qwen2-7b", shape=s, seq=q, forced=qf,
                    name=f"qwen{s}{' seq_shard' if q else ''}")
               if s != R_M4 else
               dict(kind="lm", arch="qwen2-7b", shape=s, name=f"qwen{s}",
                    layers=R_M4_LAYERS,
                    forced=forced_tokens(refs["qwen(1, 4)"]["greedy"]))
               for s, q in R_QWEN if s[0] * s[1] == 4]}
    for world, js in list(zero.items()) + list(tjobs.items()):
        jobs[world] += js
    # (u2): an r2 job at R_M4_LAYERS layers on U_ROWS over U_AXES
    ujobs.append(dict(kind="lm", arch="qwen2-7b", shape=U_ROWS, axes=U_AXES,
                      layers=R_M4_LAYERS, name=U_ROWS_NAME,
                      forced=forced_tokens(refs["qwen(1, 4)"]["greedy"])))
    jobs[4] += ujobs
    ranks, walls = {}, {}
    print(f"(r) one-rank references {ref_s:.1f} s; the card holds "
          f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB here before "
          f"the ranks start", flush=True)
    for world, js in jobs.items():
        t = time.perf_counter()
        got = run_tp_ranks(dev, world, js)
        walls[world] = time.perf_counter() - t
        print(f"(r) {world} ranks: {walls[world]:.1f} s, jobs "
              f"{ {n: round(x['job_s'], 1) for n, x in got[0].items()} }",
              flush=True)
        for job in js:
            ranks[job["name"]] = [g[job["name"]] for g in got]
    zero_names = {j["name"] for js in zero.values() for j in js}
    t_names = {j["name"] for js in tjobs.values() for j in js}
    u_names = {j["name"] for j in ujobs}
    zero_ranks = {k: ranks.pop(k) for k in list(ranks) if k in zero_names}
    t_ranks = {k: ranks.pop(k) for k in list(ranks) if k in t_names}
    u_ranks = {k: ranks.pop(k) for k in list(ranks) if k in u_names}
    t_s = time.perf_counter()
    paths = check_zero(dev, zero_ranks, zero_refs)
    s_jobs = sum(rs[0]["job_s"] for rs in zero_ranks.values())
    print(f"phase (s) ZeRO-3 layouts, on (r)'s spawns: references "
          f"{s_ref_s:.1f} s, jobs {s_jobs:.1f} s, checks "
          f"{time.perf_counter() - t_s:.1f} s")
    summary = {}
    for name, rs in ranks.items():
        if name.startswith("distilbert"):
            summary[name] = check_clf(dev, rs,
                                      R_CONFIG("distilbert-imdb"))
            counts = [x["launches"] for x in rs]
        else:
            cfg = (qcfg4 if name == f"qwen{R_M4}" else qcfg
                   if name.startswith("qwen")
                   else moe_config(name == "moe(1, 2)"))
            ref = refs.get(name, refs["qwen"])
            summary[name] = check_lm_layout(dev, name, cfg, rs, ref)
            counts = [x[mode]["counts"] for x in rs
                      for mode in ("greedy", "sampled") if mode in x]
        paths[f"tp_{name}"] = {k: sum(c[k] for c in counts)
                               for k in counts[0]}
    for name, layout in ((s, q) for s, q in R_QWEN):
        key = f"qwen{name}{' seq_shard' if layout else ''}"
        if key not in summary:
            raise AssertionError(f"(r) layout {key} did not run")
    print(f"(r) every layout held; references {ref_s:.1f} s, ranks "
          f"{json.dumps(walls)} s")
    t_c = time.perf_counter()
    paths.update(check_t(dev, t_ranks, t_refs,
                         summary["qwen(1, 2)"]["near_tie_bound"]))
    t_jobs_s = sum(rs[0]["job_s"] for rs in t_ranks.values())
    t_train_s = sum(rs[0]["job_s"] for n, rs in zero_ranks.items()
                    if n.startswith("t1"))
    print(f"phase (t) SSM/encoder-decoder under a mesh and mesh slices, on "
          f"(r)'s spawns: references {t_ref_s:.1f} s, serving jobs "
          f"{t_jobs_s:.1f} s, whisper training jobs {t_train_s:.1f} s, "
          f"checks {time.perf_counter() - t_c:.1f} s; in all "
          f"{t_ref_s + t_jobs_s + t_train_s + time.perf_counter() - t_c:.1f}"
          f" s", flush=True)
    t_c = time.perf_counter()
    paths.update(check_u(dev, u_ranks, u_ref, refs["qwen(1, 4)"],
                         summary["qwen(2, 2)"]["near_tie_bound"]))
    u_jobs_s = sum(rs[0]["job_s"] for rs in u_ranks.values())
    print(f"phase (u1)-(u2) the front door on (2, 2), rows over pod x data, "
          f"on (r)'s spawns: reference {u_ref_s:.1f} s, jobs "
          f"{u_jobs_s:.1f} s, checks {time.perf_counter() - t_c:.1f} s; in "
          f"all {u_ref_s + u_jobs_s + time.perf_counter() - t_c:.1f} s",
          flush=True)
    return paths


def main():
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of phase (h)
        rank_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--pod-worker"]:  # one rank of phase (p)
        pod_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of phase (r)
        tp_worker(sys.argv[2])
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device here; this script runs the port "
              "on a GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build(fa_ops.SOURCE, da_ops.SOURCE, fs.SOURCE)
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s "
          f"(all sources at once)")

    def phase(name, fn):
        t = time.perf_counter()
        out = fn(dev)
        torch.cuda.synchronize()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    kernels = [phase("(a) flash attention vs plain", check_kernel),
               phase("(a2) decode attention vs plain", check_decode_kernel),
               phase("(a2) fused sampling vs plain", check_sampling_kernel)]
    kernels += phase("(a3) int8 / paged decode attention vs plain",
                     check_variant_kernels)
    kernels.append(phase("(a4) partials decode attention vs plain",
                         check_partials_kernel))
    paths = {"offline_distilbert": {"flash_attention": phase(
        "(b) offline job, distilbert-imdb", run_main_path)}}
    paths["generate_qwen2_7b"], _ = phase(
        "(c) generative serving, qwen2-7b", run_generation)
    torch.cuda.empty_cache()  # phase (c)'s model is gone
    paths[f"generation_job_qwen2_7b_{serve_cluster.JOB_LAYERS}_layers"], \
        job_tokens = phase("(d) generation job, qwen2-7b widths",
                           run_generation_job)
    torch.cuda.empty_cache()
    paths["seq_shard_qwen2_7b"], seq_streams, seq_info = phase(
        "(g) seq-sharded serving, qwen2-7b, one rank", run_seq_shard)
    torch.cuda.empty_cache()
    paths["serve_cluster_main"] = phase(
        "(e) entry point serve_cluster.run",
        lambda d: run_entry_point(d, seq_streams, job_tokens))
    torch.cuda.empty_cache()
    paths["paged_int8_qwen2_7b"] = phase(
        "(f) paged and int8 serving, qwen2-7b", run_paged_int8)
    torch.cuda.empty_cache()
    paths.update(phase("(h) seq-sharded serving, ranks sharing the card",
                       lambda d: run_ranks(d, seq_info)))
    torch.cuda.empty_cache()
    paths.update(control_plane_phases(phase))
    torch.cuda.empty_cache()
    paths["batch_dag_qwen2_7b"] = phase("(n) batch DAG, qwen2-7b",
                                        run_batch_dag_phase)["counts"]
    torch.cuda.empty_cache()
    paths.update(phase("(o) training distilbert-imdb, then serving it",
                       run_training_phase))
    torch.cuda.empty_cache()
    phase("(p) training entry points, crash/resume, pod step",
          run_training_entry_points)
    torch.cuda.empty_cache()
    # (u4): CPU processes beside (q)-(t), where one process (the parent)
    # or a few ranks drive the card
    dry = start_dryruns()
    atexit.register(stop_processes, dry["procs"].values())
    paths.update(run_families(phase))
    torch.cuda.empty_cache()
    paths.update(phase("(r)-(u2) tensor-parallel and data-axis serving, "
                       "ZeRO-3, SSM/encoder-decoder models under a mesh, "
                       "mesh slices, the front door on a mesh and rows "
                       "over two data axes, ranks sharing the card", run_tp))
    torch.cuda.empty_cache()
    phase("(u) --http --mesh 2x2 as a user runs it, the dry runs",
          lambda d: run_u_tail(d, dry))
    # the path each kernel must have been launched on
    main_path = {"flash_attention": "generate_qwen2_7b",
                 "decode_attention": "generate_qwen2_7b",
                 "fused_sample": "generate_qwen2_7b",
                 "decode_attention_quant": "paged_int8_qwen2_7b",
                 "paged_decode_attention": "paged_int8_qwen2_7b",
                 "paged_decode_attention_quant": "paged_int8_qwen2_7b",
                 "decode_attention_partials": "seq_shard_qwen2_7b"}
    for k in kernels:
        by_path = {name: counts.get(k["name"], 0)
                   for name, counts in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if by_path[main_path[k["name"]]] == 0:
            raise AssertionError(f"{k['name']} was not launched on "
                                 f"{main_path[k['name']]}")
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "launches_by_path", "n_split",
             "kernel_device_ms", "kernel_device_ms_cold", "timed"]
    print(json.dumps({"kernels": [{key: k[key] for key in order if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
