#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds every hand-written kernel from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card, drives the port's main paths through their entry
points and checks what comes out:

  (a)  flash attention vs its plain version (incl. qwen2's causal GQA-7
       prefill shape), timed;
  (a2) decode attention and the fused sampling epilogue vs their plain
       versions at qwen2-7b's decode shapes, timed;
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
       processes, gloo): two ranks at full width, four at the job's depth;
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

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Any failed phase raises, so the script exits non-zero and
prints no result line; so does a machine with no CUDA device.

Usage (on a machine with one NVIDIA H100 and the CUDA toolkit):
  python3 chip_smoke.py

(``chip_smoke.py --rank-worker SPEC`` is one rank of phase (h), started by
the script itself.)

Output: the card's ``name, power.limit`` line, the build time, one line per
kernel check and per phase (with its seconds), a ``{"kernels": [...]}``
JSON line and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.benchmarks import fig2  # noqa: E402
from repro_torch.core import LatencyModel  # noqa: E402
from repro_torch.core.simulator import CaseStudyConfig  # noqa: E402
from repro_torch.data import imdb_reviews  # noqa: E402
from repro_torch.dist import collectives  # noqa: E402
from repro_torch.examples import serve_cluster  # noqa: E402
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
from repro_torch.launch.serve import run_offline  # noqa: E402
from repro_torch.models import RunConfig, build as build_model  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
from repro_torch.models.transformer import Cache, PagedCache  # noqa: E402
from repro_torch.obs import lint_prometheus  # noqa: E402
from repro_torch.router import (  # noqa: E402
    TRAFFIC, CalibratedLatencyModel, EventRouter,
    QueueDepthPolicy, ReplicaPool, make_requests)
from repro_torch.serving import Engine, PageAllocator, Request  # noqa: E402
from repro_torch.tools import trace_report  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

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
]
# the flash cases that are timed: the offline main path and one qwen2-7b
# prefill admission
TIMED_FLASH = ("main_path_bidir", "qwen2_prefill_gqa7")

# decode attention: (name, b, h, kv, d, t, lengths, window, cap, dtype).
# The first case is the serving path's shape (8 slots of a 1024-position
# cache, a few hundred positions a row) and is timed. Lengths hold 0,
# T - 1 and lengths past T (free rows that ran past the cache's end);
# every row sees at least one position.
_PATH_LENGTHS = tuple(int(x) for x in
                      np.random.default_rng(0).integers(64, 577, 8))
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
]

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


def check_kernel(dev) -> dict:
    """Phase (a): the kernel against its plain version, case by case, and
    timed at the main path's shape and at qwen2-7b's prefill."""
    errs, inputs = [], {}
    for name, b, s, t, h, kv, d, causal, window, cap, dtype in CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                   for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.shape == q.shape and math.isfinite(err) and err <= TOL[dtype]
        print(f"kernel {name}: q{tuple(q.shape)} k{tuple(k.shape)} "
              f"{str(dtype).removeprefix('torch.')} max_abs_err={err:.3g} "
              f"tol={TOL[dtype]:g} {'ok' if ok else 'FAILED'}")
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
        ms = cuda_ms(lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=cap), iters=50)
        kern_ms = kernel_device_ms(lambda: fa_ops.flash_attention(
            q, k, v, causal=causal, window=window, softcap=cap), "flash_fwd")
        plain_ms = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=cap), iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
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
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
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
                                              positions)
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


def check_decode_kernel(dev) -> dict:
    """Phase (a2), decode attention: kernel vs plain version case by case,
    timed at the serving path's shape."""
    main = None
    for name, b, h, kv, d, t, lengths, window, cap, dtype in DECODE_CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        q = torch.randn(b, h, d, generator=g, device=dev, dtype=dtype)
        k, v = (torch.randn(b, t, kv, d, generator=g, device=dev,
                            dtype=dtype) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = da_ops.decode_attention(q, k, v, lens, window=window,
                                      softcap=cap)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens, window=window, softcap=cap)
        err = (out.float() - ref.float()).abs().max().item()
        ok = out.shape == q.shape and math.isfinite(err) and err <= TOL[dtype]
        print(f"kernel decode_attention {name}: q{tuple(q.shape)} "
              f"k{tuple(k.shape)} lengths {list(lengths)} "
              f"{str(dtype).removeprefix('torch.')} max_abs_err={err:.3g} "
              f"tol={TOL[dtype]:g} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"decode_attention kernel disagrees with "
                                 f"its plain version on {name}: {err}")
        if main is None:
            main = (q, k, v, lens, window, cap, err)

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
            "kernel_device_ms": kern_ms}


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


def decode_layer_errors(cfg, params, cache, token) -> list:
    """Per layer: relative RMS error between the decode attention sublayer
    through the kernel and through the plain path, both fed the plain
    path's hidden state at that layer (the cache gets the same k/v from
    both)."""
    lengths = cache.lengths
    x = transformer._embed_in(cfg, params, token, None,
                              lengths[:, None].long())
    errs = []
    for layer, p in enumerate(params["blocks"]):
        spec = cfg.pattern[layer % cfg.period]
        c = cache.layers[layer]
        h = apply_norm(cfg, p["norm1"], x)
        ys = [attention.attn_decode_layer(cfg, p["attn"], h, c["k"], c["v"],
                                          lengths, mixer=spec.mixer,
                                          impl=impl)[0]
              for impl in ("pallas", "xla")]
        errs.append(float(torch.linalg.vector_norm(ys[0].float()
                                                   - ys[1].float())
                          / torch.linalg.vector_norm(ys[1].float())))
        x = transformer._mlp_residual(cfg, spec, p, x + ys[1])
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
    counts read around it: the partials kernel 28 x rounds and, sampled,
    the sampling kernel once an admission and once a round, nothing else
    (prefill takes the plain path); the cache's tensors at one address
    every round."""
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
    """Phase (g): full-width qwen2-7b through ``Engine(mesh=(1, 1),
    seq_shard=True)`` behind ``ContinuousBatcher``: greedy and sampled at
    the reference's init (the main path), then on tamed q/k against the
    dense kernel path (teacher-forced and greedy streams) and a decode
    round on CUDA events. Returns the launch counts, the greedy streams at
    the reference's init and, for phase (h), the tamed streams and the
    near-tie bound."""
    cfg = configs.get("qwen2-7b")
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
    return counts, greedy["streams"], {"streams": tamed["streams"],
                                       "tie": tie}


# ---------------------------------------------------------------------------
# Phase (e): the example's entry point, as a user runs it
# ---------------------------------------------------------------------------


def run_entry_point(dev, greedy_streams, job_tokens) -> dict:
    """``serve_cluster.main([])`` on the card: every request served through
    the one-rank seq-shard mesh in one decode call a round, the launches
    its runs imply, and the same greedy streams and job tokens as phases
    (g) and (d), which took its sizes."""
    torch.cuda.synchronize()
    reset_counts()
    out = serve_cluster.main([])
    torch.cuda.synchronize()
    counts = read_counts()
    n_layers = configs.get("qwen2-7b").n_layers
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
    print(f"entry point serve_cluster.main([]): launches {counts}; greedy "
          f"streams and job tokens equal phases (g) and (d)")
    return counts


# ---------------------------------------------------------------------------
# Phase (f): paged and int8 serving at full width
# ---------------------------------------------------------------------------

PAGED = serve_cluster.PAGED_CARD_SIZES
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
        x = transformer._mlp_residual(cfg, spec, p, x + ys[1].to(x.dtype))
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
    """Phase (f): full-width qwen2-7b on the shared-prefix workload, dense
    int8, paged bf16, paged int8 and paged int8 fused-sampled, beside a
    dense bf16 run; returns the launch counts of its serving runs."""
    cfg = configs.get("qwen2-7b")
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

# (name, ranks, layers, requests): two ranks at full width on the card
# sizes, then four at the job's depth on fewer requests (the only run
# where one row spans more than two shards)
RANK_RUNS = [("seq_shard_qwen2_7b_2_ranks", 2, None, GEN.n_requests),
             ("seq_shard_qwen2_7b_4_layers_4_ranks", 4,
              serve_cluster.JOB_LAYERS, 8)]
RANK_TIMEOUT_S = 600


def rank_worker(spec_path: str):
    """One rank of phase (h), started by ``launch.mesh.spawn_ranks``: the
    tamed model (seed ``SEED``) on a (1, ranks) seq-shard mesh, gloo on the
    shared card; continuous batching with its launch counts, the cache's
    block and address, a decode round on CUDA events, and the time spent
    in all_reduce per round. Rank 0 also holds the streams to the given
    ones (or, without any, to a single-device dense kernel run of the same
    model) at near-ties. Writes its result as JSON beside the spec."""
    spec = json.loads(Path(spec_path).read_text())
    dev = init_from_env("cuda")
    rank, world = rank_env()
    cfg = configs.get("qwen2-7b")
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
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
           "idle_share": 1 - prof["busy_ms"] / round_ms}
    if rank == 0:
        want = spec.get("streams")
        if want is None:  # the same model on one device, dense kernels
            dense = Engine(model, serve_cluster.RUN, device=dev)
            ref = serve_cluster.make_requests(
                cfg.vocab_size, spec["n_requests"], GEN.prompt_len,
                GEN.new_tokens, SEED)
            serve_cluster.serve(dense, params, ref, n_slots=GEN.n_slots,
                                max_len=GEN.max_len, seed=SEED)
            want = [r.generated for r in ref]
        out["parted"] = parted_at_near_ties(
            engine, params, [r.prompt for r in reqs], want, res["streams"],
            spec["tie"])
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))


def run_ranks(dev, seq_info) -> dict:
    """Phase (h): ``RANK_RUNS``, each as spawned processes sharing the card
    (gloo); the streams bit-identical on every rank and, at near-ties, equal
    to phase (g)'s (two ranks, full width) or to one device's (four ranks).
    Returns each run's per-rank launch counts, summed."""
    torch.cuda.empty_cache()
    paths = {}
    for name, ranks, layers, n_req in RANK_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"layers": layers, "n_requests": n_req, "out": tmp,
                    "tie": seq_info["tie"],
                    "streams": None if layers else seq_info["streams"]}
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
              f"{'phase (g)' if layers is None else 'one device'} at "
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
# shape; the fit must explain them to within CAL_RMSE_FRAC of its overhead
CAL_SLOTS, CAL_STEPS, CAL_REPEATS, CAL_RMSE_FRAC = (1, 2, 4, 8), 64, 5, 0.2
HTTP_CLIENTS = 24              # (l): three replicas' slots
HTTP_TIMEOUT_S = 300.0
# (m): the command line at main()'s smoke config: clients of --http, and
# how long it serves them
CLI_HTTP_CLIENTS, CLI_SERVE_S = 6, 10.0


class _AdmitSpy:
    """Counts the engine's admission calls (dense and paged, greedy and
    fused), each of which prefills one request."""

    NAMES = ("prefill_into", "prefill_into_sample", "extend_row",
             "extend_row_sample")

    def __init__(self, engine):
        self.engine, self.calls = engine, 0

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.engine, name)

            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(self.engine, name, counted)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.engine, name)


def routed(engine, params, cfg, label, tag="(j)", **kw) -> dict:
    """One ``launch.serve.run_router`` call with the launch counts set to
    0 just before and read just after; checks that every request of every
    policy's run completed, one decode call a round, and that no replica
    made a shape bucket the engine did not already have."""
    buckets = engine.compile_count
    torch.cuda.synchronize()
    reset_counts()
    with _AdmitSpy(engine) as spy:
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


def main():
    if sys.argv[1:2] == ["--rank-worker"]:  # one rank of phase (h)
        rank_worker(sys.argv[2])
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
        "(e) entry point serve_cluster.main",
        lambda d: run_entry_point(d, seq_streams, job_tokens))
    torch.cuda.empty_cache()
    paths["paged_int8_qwen2_7b"] = phase(
        "(f) paged and int8 serving, qwen2-7b", run_paged_int8)
    torch.cuda.empty_cache()
    paths.update(phase("(h) seq-sharded serving, ranks sharing the card",
                       lambda d: run_ranks(d, seq_info)))
    torch.cuda.empty_cache()
    paths.update(control_plane_phases(phase))
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
