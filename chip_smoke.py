#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Builds every hand-written kernel from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's main
path through its entry point — the paper's offline batch job on the
full-width ``distilbert-imdb`` encoder, monolithic and then parallel — and
checks what comes out. Any failed phase raises, so the script exits
non-zero and prints no result line; so does a machine with no CUDA device.

Usage (on a machine with one NVIDIA H100 and the CUDA toolkit):
  python3 chip_smoke.py

Output: the card's ``name, power.limit`` line, the build time, one line per
kernel check and per offline run, a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.launch.serve import run_offline  # noqa: E402
from repro_torch.models import RunConfig  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402
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
]


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
                        "flash_attention.py:83",
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
    built = build.build(fa_ops.SOURCE)
    print(f"build: {json.dumps(built)} in {time.perf_counter() - t0:.1f} s "
          f"(all sources at once)")

    kernel = check_kernel(dev)
    kernel["launches"] = run_main_path(dev)
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{key: kernel[key] for key in order}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
