"""Sampling epilogue: temperature / top-k / top-p filters and the
Gumbel-argmax draw, with a hand-written CUDA kernel for the epilogue.

Counterpart of ``repro.kernels.decode_attention.fused_sampling``:

  * :func:`apply_filters` — the canonical filter math; the host sampler
    (``serving.sampler.sample``) is ``argmax(apply_filters(logits) +
    gumbel)``, so the host and fused paths agree by construction.
  * :func:`nucleus_cutoff` — the per-row top-p cutoff probability; it
    needs a vocabulary sort, so it runs in torch ops outside the kernel,
    exactly where the reference computes it.
  * :func:`fused_sample_ref` — the plain torch version of the epilogue.
  * :func:`fused_sample_kernel` — the epilogue: the CUDA kernel
    (``fused_sampling.cu``) on CUDA tensors, the plain version on CPU
    tensors. Noise and cutoff are explicit inputs, as in the reference.
    The kernel splits each row over a thread-block cluster of ``n_split``
    blocks (:func:`choose_sample_split`), each holding its slice of the
    row in shared memory (:func:`staging`).
  * :func:`fused_sample` — the entry point the serving engine calls.

Randomness: ``jax.random`` keys become a ``torch.Generator``. Gumbel noise
is drawn as ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``, from the
generator on the logits' device. torch cannot reproduce threefry, so the
tests feed the reference's noise through the ``noise=`` seams.

Numerics: the plain version takes top-p probabilities from
``torch.softmax``, as ``apply_filters`` and ``nucleus_cutoff`` do, so on
the CPU the fused path is bit-identical to the host sampler. The kernel
computes ``exp(z - max) / sum`` in its own reduction order, which moves p
by a few ulps; so it drops a token only when p is below the cutoff by more
than a relative 2^-14, and always keeps the top slot (``fused_sampling.cu``).
Kernel and plain version can then differ only where a token's probability
lies within that margin below the cutoff: a near-tie.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = Path(__file__).with_name("fused_sampling.cu")
# The kernel's relative top-p margin (TOP_P_SLACK in fused_sampling.cu): it
# drops a token only when its p is below the cutoff by more than this.
TOP_P_SLACK = 2.0 ** -14

# The kernel's cluster: at most CLUSTER_LIMIT blocks a row (the portable
# cluster size, MAX_SPLIT in fused_sampling.cu), each with at least
# MIN_SLICE elements where the row has them. MAX_DYN_SMEM is the kernel's
# dynamic shared memory (MAX_DYN_SMEM in fused_sampling.cu).
CLUSTER_LIMIT = 8
MIN_SLICE = 4096
MAX_DYN_SMEM = 192 * 1024

launches = 0  # kernel launches; callers reset it to count one run


# ---------------------------------------------------------------------------
# Canonical filter math (shared by the host sampler and the fused path)
# ---------------------------------------------------------------------------


def apply_filters(logits, *, temperature: float,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """Temperature / top-k / top-p filtered logits, (B, V) -> (B, V).

    Requires ``temperature > 0``. Filter order is k then p. ``top_k``
    keeps every tie at the k-th value; ``top_p`` keeps the smallest
    probability-sorted prefix whose mass reaches ``top_p``, boundary ties
    kept and the top slot always in (``top_p <= 0`` leaves the argmax;
    ``top_p >= 1`` is a no-op). Masked slots are set to ``-1e30``.
    """
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        cutoff = nucleus_cutoff(logits, top_p)
        probs = torch.softmax(logits, dim=-1)
        logits = torch.where(probs < cutoff, NEG_INF, logits)
    return logits


def nucleus_cutoff(logits, top_p: float):
    """Per-row top-p cutoff probability, (B, V) -> (B, 1) fp32: the
    smallest probability inside the nucleus (a sorted slot is in iff the
    mass strictly before it is < ``top_p``; the top slot always is)."""
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    in_nucleus = (cum - sorted_probs) < top_p
    in_nucleus[:, 0] = True
    return torch.where(in_nucleus, sorted_probs, torch.inf).amin(
        dim=-1, keepdim=True)


def gumbel_noise(shape, generator: Optional[torch.Generator], device):
    """Standard Gumbel noise, fp32, drawn from ``generator`` on
    ``device``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32).clamp_min_(tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# The epilogue: plain version and kernel
# ---------------------------------------------------------------------------


def fused_sample_ref(logits, gumbel, cutoff, *, temperature: float,
                     top_k: Optional[int] = None, use_top_p: bool = False):
    """Plain torch epilogue. logits/gumbel: (B, V); cutoff: (B, 1) fp32
    (ignored unless ``use_top_p``). Returns (B,) int32 token ids."""
    z = apply_filters(logits.float(), temperature=temperature, top_k=top_k)
    if use_top_p:
        z = torch.where(torch.softmax(z, dim=-1) < cutoff.float(), NEG_INF,
                        z)
    y = z + gumbel.float()
    return torch.argmax(y, dim=-1).to(torch.int32)  # first index of the max


def staging(v: int, n_split: int) -> str:
    """What the kernel keeps in shared memory for a row of ``v`` split
    over ``n_split`` blocks (``staging`` in fused_sampling.cu): "both"
    (the logits and the noise slice), "logits", or "none" (every pass
    reads device memory)."""
    per = -(-v // n_split)
    region = (per + 6) // 4 * 4  # 16-byte alignment slack, in floats
    if 8 * region <= MAX_DYN_SMEM:
        return "both"
    return "logits" if 4 * region <= MAX_DYN_SMEM else "none"


def choose_sample_split(b: int, v: int, sms: int) -> int:
    """Blocks of one cluster per row, from the batch, the vocabulary and
    the card's SM count (never the data): at most CLUSTER_LIMIT, no more
    blocks than fill the card once, each at least MIN_SLICE elements;
    and, up to CLUSTER_LIMIT, enough that both slices fit in a block's
    shared memory."""
    n = max(1, min(CLUSTER_LIMIT, sms // b, v // MIN_SLICE))
    while n < CLUSTER_LIMIT and staging(v, n) != "both":
        n += 1
    return n


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load(SOURCE).fused_sample_fwd
    # (logits, gumbel, cutoff, out, batch, v, temperature, top_k,
    #  use_top_p, n_split, stream)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_sample_kernel(logits, gumbel, cutoff, *, temperature: float,
                        top_k: Optional[int] = None,
                        use_top_p: bool = False,
                        n_split: Optional[int] = None):
    """The sampling epilogue. logits/gumbel: (B, V) fp32; cutoff: (B, 1)
    fp32 (ignored unless ``use_top_p``). Returns (B,) int32 token ids.
    Requires ``temperature > 0`` (greedy is a plain argmax, no kernel).
    ``n_split`` (1 .. 8) sets the kernel's blocks per row; by default
    :func:`choose_sample_split` picks it. The plain version ignores it."""
    if logits.ndim != 2 or gumbel.shape != logits.shape:
        raise ValueError(f"want logits and gumbel (B, V); got "
                         f"{tuple(logits.shape)}, {tuple(gumbel.shape)}")
    b, v = logits.shape
    if tuple(cutoff.shape) != (b, 1):
        raise ValueError(f"cutoff must be ({b}, 1), got "
                         f"{tuple(cutoff.shape)}")
    if not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if top_k is not None and not 1 <= top_k <= v:
        raise ValueError(f"top_k must lie in [1, {v}], got {top_k}")
    if n_split is not None and not 1 <= n_split <= CLUSTER_LIMIT:
        raise ValueError(f"n_split must lie in [1, {CLUSTER_LIMIT}], got "
                         f"{n_split}")
    build.refuse_fake(logits, gumbel, cutoff)
    if all(x.device.type == "cpu" for x in (logits, gumbel, cutoff)):
        return fused_sample_ref(logits, gumbel, cutoff,
                                temperature=temperature, top_k=top_k,
                                use_top_p=use_top_p)
    for name, x in (("logits", logits), ("gumbel", gumbel),
                    ("cutoff", cutoff)):
        if x.device.type != "cuda" or x.device != logits.device:
            raise ValueError(
                f"{name} is on {x.device}: the kernel takes logits, noise "
                f"and cutoff on one CUDA device (CPU tensors take the "
                f"plain version)")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} is {x.dtype}: the kernel takes fp32")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = logits.device
    if n_split is None:
        n_split = choose_sample_split(b, v, _sm_count(dev.index or 0))
    fn = _kernel()
    out = torch.empty(b, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), gumbel.data_ptr(), cutoff.data_ptr(),
                 out.data_ptr(), b, v, float(temperature), top_k or 0,
                 int(use_top_p), n_split,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_sample kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Entry point (what the engine calls for fused sampling)
# ---------------------------------------------------------------------------


def fused_sample(logits, generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, noise=None):
    """Sample (B, V) logits -> (B,) int32 through the epilogue.

    ``temperature <= 0`` is greedy argmax (no draw, no kernel). Otherwise
    the top-p cutoff is computed here in torch ops (after the top-k mask,
    as the reference does), Gumbel noise is drawn from ``generator`` (or
    taken from ``noise``), and the epilogue filters and draws. At the same
    generator state the tokens equal ``serving.sampler.sample``'s over the
    same logits (on the card up to top-p cutoff near-ties).
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float()
    use_top_p = top_p is not None and top_p < 1.0
    if use_top_p:
        cutoff = nucleus_cutoff(apply_filters(
            logits, temperature=temperature, top_k=top_k), top_p)
    else:
        cutoff = torch.zeros((logits.shape[0], 1), dtype=torch.float32,
                             device=logits.device)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return fused_sample_kernel(logits.contiguous(), noise.contiguous(),
                               cutoff.contiguous(), temperature=temperature,
                               top_k=top_k, use_top_p=use_top_p)
