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
  (b)  the paper's offline batch job on the full-width ``distilbert-imdb``
       encoder, monolithic and then parallel;
  (c)  generative serving on the full-width ``qwen2-7b`` (random weights):
       continuous batching of 24 requests over 8 slots, greedy, then with
       fused sampling, then with host sampling;
  (d)  the orchestrated generation job under injected faults at full
       width and reduced depth;
  (e)  the example's entry point as a user runs it on the card
       (``python -m repro_torch.examples.serve_cluster``), whose sizes
       phases (c) and (d) share: its greedy streams and its job's tokens
       equal theirs.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Any failed phase raises, so the script exits non-zero and
prints no result line; so does a machine with no CUDA device.

Usage (on a machine with one NVIDIA H100 and the CUDA toolkit):
  python3 chip_smoke.py

Output: the card's ``name, power.limit`` line, the build time, one line per
kernel check and per phase (with its seconds), a ``{"kernels": [...]}``
JSON line and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import imdb_reviews  # noqa: E402
from repro_torch.examples import serve_cluster  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import \
    fused_sampling as fs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.launch.serve import run_offline  # noqa: E402
from repro_torch.models import RunConfig, build as build_model  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
from repro_torch.models.transformer import Cache  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
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

# fused sampling at the serving path's (8 slots, qwen2 vocabulary) shape;
# "path" is the sampled serving run's setting and is timed
VOCAB = 152064
SAMPLE_CASES = [
    ("path", dict(temperature=0.8, top_k=50, top_p=0.95)),
    ("temperature", dict(temperature=0.8)),
    ("top_k", dict(temperature=0.8, top_k=50)),
    ("top_p", dict(temperature=0.8, top_p=0.9)),
    ("top_k_ties", dict(temperature=1.0, top_k=50)),
    ("top_p_zero", dict(temperature=1.0, top_p=0.0)),
    ("top_p_negative", dict(temperature=1.0, top_p=-0.5)),
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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
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


def attention_bound_ms(q, k, v, causal, window) -> tuple:
    """(least ms, "bytes" or "operations") for one attention call: q, k, v
    read once and o written once; two products over the visible (row,
    column) pairs of these inputs."""
    b, s, h, d = q.shape
    t = k.shape[1]
    rows = torch.arange(s)[:, None]
    cols = torch.arange(t)[None, :]
    visible = torch.ones(s, t, dtype=torch.bool)
    if causal:
        visible &= cols <= rows
    if window is not None:
        visible &= cols > rows - window
    flops = 4.0 * b * h * d * int(visible.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(dev) -> dict:
    """Phase (a): the kernel against its plain version, case by case, and
    timed at the main path's shape."""
    main = None
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
        if main is None:
            main = (q, k, v, causal, window, cap, err)

    q, k, v, causal, window, cap, err = main
    ms = cuda_ms(lambda: fa_ops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=cap), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention_ref(
        q, k, v, causal=causal, window=window, softcap=cap), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D) views
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), iters=20)
    bound_ms, bound_by = attention_bound_ms(q, k, v, causal, window)
    print(f"kernel flash_attention at the main path's shape "
          f"{tuple(q.shape)}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:87",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
        layer_err = attention_layer_errors(cfg, out["params"], batch)
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


def decode_bound_ms(q, k, lengths, window) -> tuple:
    """(least ms, "bytes" or "operations") of one decode-attention call on
    these inputs: q, lengths and o once, and the k and v rows each row can
    see; two products over the visible positions."""
    b, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    lens = lengths.long().cpu()
    hi = torch.clamp(lens, max=t - 1)
    lo = torch.zeros_like(lens) if window is None else torch.clamp(
        lens - window + 1, min=0)
    visible = int(torch.clamp(hi - lo + 1, min=0).sum())
    nbytes = (2 * q.numel() * q.element_size() + 4 * b
              + 2 * visible * kv * d * k.element_size())
    flops = 4.0 * visible * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    bound_ms, bound_by = decode_bound_ms(q, k, lens, window)
    print(f"kernel decode_attention at the serving path's shape "
          f"q{tuple(q.shape)} k{tuple(k.shape)}: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "decode_attention.py:202",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def check_sampling_kernel(dev) -> dict:
    """Phase (a2), the sampling epilogue at (8, vocab): tokens equal the
    plain version's except at top-p near-ties (none allowed without
    top-p); timed at the sampled serving path's setting."""
    main = None
    for name, kw in SAMPLE_CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        logits = torch.randn(8, VOCAB, generator=g, device=dev) * 3
        if name == "top_k_ties":  # 5 above, then 60 tied at the 50th value
            logits[:, :5] = 30.0
            logits[:, 100:160] = 25.0
        flips, rows = [], 0
        for _ in range(4):
            inputs = sampling_inputs(logits, kw, g)
            got = fs.fused_sample_kernel(**inputs)
            torch.cuda.synchronize()
            want = fs.fused_sample_ref(**inputs)
            flips += sampling_flips(inputs, got, want)
            rows += logits.shape[0]
            if name == "top_k_ties":  # every tie stays eligible
                kept = set(range(5)) | set(range(100, 160))
                assert all(int(x) in kept for x in want.tolist())
            if name.startswith("top_p_") and not flips:
                assert torch.equal(got, logits.argmax(-1).int())
        check_flips(name, kw, flips)
        print(f"kernel fused_sample {name} {kw}: {rows} rows, "
              f"{len(flips)} flips vs plain "
              f"{[round(min(f[1]), 9) for f in flips]} (|p - cutoff| / "
              f"cutoff) ok")
        if main is None:
            main = (inputs, len(flips))
    inputs, n_flips = main
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
          f"{SAMPLE_CASES[0][1]}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"no single library call, bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "fused_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/"
                      "fused_sampling.cu",
            "replaces": "src/repro/kernels/decode_attention/"
                        "fused_sampling.py:171",
            # a sampler's error is its tokens: flips vs the plain version
            "max_abs_err": float(n_flips), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# Phase (c): generative serving at full width
# ---------------------------------------------------------------------------

# the example's card sizes, seed and run config (full-width qwen2-7b)
GEN = serve_cluster.CARD_SIZES
SEED = serve_cluster.SEED


def reset_counts():
    fa_ops.launches = da_ops.launches = fs.launches = 0


def read_counts() -> dict:
    return {"flash_attention": fa_ops.launches,
            "decode_attention": da_ops.launches,
            "fused_sample": fs.launches}


def clone_cache(cache: Cache) -> Cache:
    return Cache(layers=tuple({n: t.clone() for n, t in layer.items()}
                              for layer in cache.layers),
                 lengths=cache.lengths.clone())


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
    want = {"flash_attention": cfg.n_layers * admissions,
            "decode_attention": cfg.n_layers * b.decode_dispatches,
            "fused_sample": (admissions + b.decode_dispatches
                             if b.fused_sampling else 0)}
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
    del spy
    check_flips("serving path", serve_cluster.SAMPLING, flips)
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
    # (kernel events only: an op's own device time repeats its kernels')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            engine.decode(params, check, tok)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches_per_round = sum(e.count for e in kernels) / n_prof
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    breakdown = {e.key[:60]: round(e.self_device_time_total / n_prof, 1)
                 for e in top}
    busy_ms = device_us / n_prof / 1e3
    idle = 1 - busy_ms / decode_ms if device_us else None
    print(f"decode round (8 slots, CUDA events): kernel path {decode_ms:.3f}"
          f" ms, plain attention {decode_plain_ms:.3f} ms; prefill of "
          f"{len(longest)} tokens {prefill_ms:.3f} ms; profiled: device busy "
          f"{busy_ms:.3f} ms a round in {launches_per_round:.0f} kernel "
          f"launches ({window_us / n_prof / 1e3:.3f} ms a round under the "
          f"profiler), idle share of the unprofiled round "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; top "
          f"kernels (us/round) {breakdown}")

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
        "streams_differing_fused_vs_host": len(differ),
        "decode_layer_rel_err_max": max(layer_err),
        "plain_logit_err_vs_fp64": noise, "kernel_logit_err_vs_fp64":
        logit_err, "decode_round_ms": decode_ms,
        "decode_round_plain_attention_ms": decode_plain_ms,
        "prefill_ms_longest": prefill_ms, "round_device_busy_ms": busy_ms,
        "round_kernel_launches": launches_per_round,
        "profiled_round_wall_ms": window_us / n_prof / 1e3,
        "idle_share": idle, "round_breakdown_us": breakdown})
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
    want = {"flash_attention": cfg.n_layers * n_inv,
            "decode_attention": cfg.n_layers * n_inv * (new_tokens - 1),
            "fused_sample": 0}
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
# Phase (e): the example's entry point, as a user runs it
# ---------------------------------------------------------------------------


def run_entry_point(dev, greedy_streams, job_tokens) -> dict:
    """``serve_cluster.main([])`` on the card: every request served in one
    decode call a round, the launches its runs imply, and the same greedy
    streams and job tokens as phases (c) and (d), which took its sizes."""
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
        want["flash_attention"] += n_layers * admissions
        want["decode_attention"] += n_layers * b.decode_dispatches
        if b.fused_sampling:
            if b.sampler_dispatches:
                raise AssertionError(f"{b.sampler_dispatches} host-sampler "
                                     f"steps with fused sampling")
            want["fused_sample"] += admissions + b.decode_dispatches
    n_inv = out["job"]["report"].n_invocations
    want["flash_attention"] += serve_cluster.JOB_LAYERS * n_inv
    want["decode_attention"] += (serve_cluster.JOB_LAYERS * n_inv
                                 * (GEN.job_new_tokens - 1))
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    streams = [r.generated for r in out["greedy"]["requests"]]
    if streams != greedy_streams:
        raise AssertionError("the entry point's greedy streams differ from "
                             "phase (c)'s")
    if not np.array_equal(out["job"]["tokens"], job_tokens):
        raise AssertionError("the entry point's job tokens differ from "
                             "phase (d)'s")
    print(f"entry point serve_cluster.main([]): launches {counts}; greedy "
          f"streams and job tokens equal phases (c) and (d)")
    return counts


def main():
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
    paths = {"offline_distilbert": {"flash_attention": phase(
        "(b) offline job, distilbert-imdb", run_main_path)}}
    paths["generate_qwen2_7b"], streams = phase(
        "(c) generative serving, qwen2-7b", run_generation)
    torch.cuda.empty_cache()  # phase (c)'s model is gone
    paths[f"generation_job_qwen2_7b_{serve_cluster.JOB_LAYERS}_layers"], \
        job_tokens = phase("(d) generation job, qwen2-7b widths",
                           run_generation_job)
    torch.cuda.empty_cache()
    paths["serve_cluster_main"] = phase(
        "(e) entry point serve_cluster.main",
        lambda d: run_entry_point(d, streams, job_tokens))
    for k in kernels:
        by_path = {name: counts.get(k["name"], 0)
                   for name, counts in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if by_path["generate_qwen2_7b"] == 0:
            raise AssertionError(f"{k['name']} was not launched on the "
                                 f"generative path")
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "launches_by_path"]
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
