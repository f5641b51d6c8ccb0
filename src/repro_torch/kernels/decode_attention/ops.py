"""Public wrappers for the hand-written decode-attention kernels.

Counterpart of ``repro.kernels.decode_attention.ops``:
``decode_attention`` (dense cache, bf16/fp32 or int8 with per-token
scales), ``paged_decode_attention`` (a shared page pool read through a
per-row page table, bf16/fp32 or int8) and ``decode_attention_partials``
(one sequence shard's unnormalised ``(num, den, m)``, the per-shard block
of ``dist.collectives``). For CUDA tensors every call launches its CUDA
kernel (``decode_attention.cu``, one entry point per variant) at every
size: the reference's fallbacks to its oracle (``T < 64``,
``ps * Pmax < 64``) are not carried over and T is never padded. For CPU
tensors, and only for them, the plain version (``ref.py``) runs.

Each variant counts its own launches: ``launches`` (dense),
``quant_launches`` (dense int8), ``paged_launches``,
``paged_quant_launches`` and ``partials_launches``.

The kernel works one (row, kv head) with a thread-block cluster of
``n_split`` blocks, each taking a chunk of the row's visible range and
merging through distributed shared memory; :func:`choose_n_split` picks
the cluster size from what the host knows without reading the lengths.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_quant_ref,
    decode_attention_ref,
    paged_decode_attention_quant_ref, paged_decode_attention_ref,
    row_lengths)

SOURCE = Path(__file__).with_name("decode_attention.cu")
HEAD_DIMS = (16, 32, 64, 128, 192)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64           # positions per kernel tile (BLOCK_T)
CLUSTER_LIMIT = 8   # the portable thread-block cluster size

# kernel launches per variant; callers reset them to count one run
launches = 0
quant_launches = 0
paged_launches = 0
paged_quant_launches = 0
partials_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v[, k_scale, v_scale], lengths[, page_table], o, is_bf16, ...,
#  cap, n_split, stream)
_ARGTYPES = {
    "decode_attention_fwd": [_P] * 5 + [_I] * 7 + [_F, _I, _P],
    "decode_attention_quant_fwd": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "paged_decode_attention_fwd": [_P] * 6 + [_I] * 9 + [_F, _I, _P],
    "paged_decode_attention_quant_fwd": [_P] * 8 + [_I] * 9 + [_F, _I, _P],
    # (q, k, v, lengths, num, den, m, is_bf16, b, t, h, kv, d, offset,
    #  window, cap, n_split, stream)
    "decode_attention_partials_fwd": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
}


def choose_n_split(pairs: int, sms: int, max_visible: int) -> int:
    """Blocks of one cluster per (row, kv head).

    ``pairs`` is B * KV (one cluster each), ``sms`` the card's SM count and
    ``max_visible`` the longest range a row can see (the capacity, or the
    window when smaller). One block a pair once the pairs alone fill the
    card; else enough blocks for about two an SM, never more than the
    portable cluster size nor than the tiles a row can have.
    """
    if pairs >= sms:
        return 1
    tiles = max(1, -(-max_visible // TILE))
    return max(1, min(CLUSTER_LIMIT, (2 * sms) // pairs, tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _n_split(q, pairs: int, capacity: int, window) -> int:
    visible = capacity if window is None else min(capacity, window)
    return choose_n_split(pairs, _sm_count(q.device.index or 0), visible)


_ENTRIES = {}  # entry name -> its ctypes function, set up once


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        lib = build.load(SOURCE)
        for entry, argtypes in _ARGTYPES.items():
            f = getattr(lib, entry)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _ENTRIES[entry] = f
        fn = _ENTRIES[name]
    return fn


def _lengths(lengths, b: int, device):
    """(B,) int32 lengths on ``device``, contiguous; a tensor already so is
    taken as it is (the serving path's case, every layer)."""
    if (isinstance(lengths, torch.Tensor) and lengths.dtype == torch.int32
            and lengths.shape == (b,) and lengths.device == device
            and lengths.is_contiguous()):
        return lengths
    return row_lengths(lengths, b, device).contiguous()


def _on_cpu(*xs) -> bool:
    build.refuse_fake(*xs)
    return all(x.device.type == "cpu" for x in xs if x is not None)


def _check_cuda_inputs(q, kv_dtype, named):
    """Every tensor on q's CUDA device and contiguous; q in DTYPES; the
    caches (or pools) of ``kv_dtype`` and 16-byte aligned."""
    dev = q.device
    for name, x in named:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{name} is on {x.device}: the kernel takes every input on "
                f"one CUDA device (CPU tensors take the plain version)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, x in named:
        if name in ("k_cache", "v_cache", "k_pages", "v_pages"):
            if x.dtype != kv_dtype:
                raise ValueError(f"{name} is {x.dtype}, want {kv_dtype}")
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (the "
                                 f"kernel loads 16 bytes at a time)")


def _check_common(q, k, v, kv_shape_name: str, window, softcap):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,D) and {kv_shape_name}; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kv = k.shape[2]
    if k.shape[3] != d:
        raise ValueError(f"{kv_shape_name} {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    if min(b, k.shape[0], k.shape[1], h) < 1:
        raise ValueError(f"empty decode attention: q {tuple(q.shape)}, "
                         f"{kv_shape_name} {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _check_scales(k, k_scale, v_scale):
    """int8 data with fp32 (..., 1) scales beside it, or neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass k_scale and v_scale together")
    if k_scale is None:
        return False
    want = tuple(k.shape[:-1]) + (1,)
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(s.shape) != want or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {want}, got "
                             f"{s.dtype} {tuple(s.shape)}")
    if k.dtype != torch.int8:
        raise ValueError(f"scales mark an int8 cache, got {k.dtype}")
    return True


def _launch(fn_name: str, q, *args):
    """One launch on q's device and current stream (the host's share of a
    decode round: switch devices only when q is not on the current one)."""
    fn = _entry(fn_name)
    index = q.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")


def decode_attention(q, k_cache, v_cache, lengths, *, k_scale=None,
                     v_scale=None, window: Optional[int] = None,
                     softcap: Optional[float] = None):
    """q: (B,H,D); caches: (B,T,KV,D); lengths: () or (B,) int32.

    Returns (B,H,D) in q's dtype; row b attends kv positions
    j <= lengths[b], and j > lengths[b] - window when a window is set. A
    length at or past T sees every position (the reference's clamped-write
    semantics). ``k_scale``/``v_scale`` (both (B,T,KV,1) fp32, or both
    None) mark the caches as int8 with per-token scales: the int8 kernel
    dequantizes in the tile.
    """
    _check_common(q, k_cache, v_cache, "caches (B,T,KV,D)", window, softcap)
    quant = _check_scales(k_cache, k_scale, v_scale)
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    lengths = _lengths(lengths, b, q.device)
    if _on_cpu(q, k_cache, v_cache, k_scale, v_scale):
        if quant:
            return decode_attention_quant_ref(q, k_cache, v_cache, k_scale,
                                              v_scale, lengths,
                                              window=window, softcap=softcap)
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, softcap=softcap)
    named = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
             ("lengths", lengths)]
    if quant:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_cuda_inputs(q, torch.int8 if quant else q.dtype, named)
    out = torch.empty_like(q)
    dims = (int(q.dtype == torch.bfloat16), b, t, h, kv, d, window or 0,
            float(softcap or 0.0), _n_split(q, b * kv, t, window))
    global launches, quant_launches
    if quant:
        _launch("decode_attention_quant_fwd", q, q.data_ptr(),
                k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                *dims)
        quant_launches += 1
    else:
        _launch("decode_attention_fwd", q, q.data_ptr(), k_cache.data_ptr(),
                v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                *dims)
        launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_table, *,
                           k_scale=None, v_scale=None,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None):
    """Decode attention through a block-paged KV cache.

    q: (B,H,D); pools: (P, page_size, KV, D); page_table: (B, Pmax) int32;
    lengths: () or (B,) int32. Row b attends LOGICAL positions
    j <= lengths[b] (and j > lengths[b] - window when windowed); its
    logical page i is physical page ``page_table[b, i]``, and a length at
    or past ``Pmax * page_size`` sees every logical position. Table
    entries must lie in [0, P). Returns (B,H,D) in q's dtype.
    ``k_scale``/``v_scale`` (both (P, page_size, KV, 1) fp32 pools, or
    both None) mark the pools as int8; the scales are read through the
    same table.
    """
    _check_common(q, k_pages, v_pages, "pools (P,ps,KV,D)", window, softcap)
    quant = _check_scales(k_pages, k_scale, v_scale)
    b, h, d = q.shape
    n_pages, ps, kv = k_pages.shape[:3]
    if page_table.ndim != 2 or page_table.shape[0] != b or \
            page_table.shape[1] < 1:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not "
                         f"(B={b}, Pmax)")
    lengths = _lengths(lengths, b, q.device)
    if _on_cpu(q, k_pages, v_pages, k_scale, v_scale, page_table):
        if quant:
            return paged_decode_attention_quant_ref(
                q, k_pages, v_pages, k_scale, v_scale, lengths, page_table,
                window=window, softcap=softcap)
        return paged_decode_attention_ref(q, k_pages, v_pages, lengths,
                                          page_table, window=window,
                                          softcap=softcap)
    if page_table.dtype != torch.int32:
        raise ValueError(f"page_table is {page_table.dtype}, want int32")
    named = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
             ("lengths", lengths), ("page_table", page_table)]
    if quant:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_cuda_inputs(q, torch.int8 if quant else q.dtype, named)
    out = torch.empty_like(q)
    pmax = page_table.shape[1]
    dims = (int(q.dtype == torch.bfloat16), b, n_pages, ps, pmax, h, kv, d,
            window or 0, float(softcap or 0.0),
            _n_split(q, b * kv, pmax * ps, window))
    global paged_launches, paged_quant_launches
    if quant:
        _launch("paged_decode_attention_quant_fwd", q, q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), lengths.data_ptr(),
                page_table.data_ptr(), out.data_ptr(), *dims)
        paged_quant_launches += 1
    else:
        _launch("paged_decode_attention_fwd", q, q.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
                page_table.data_ptr(), out.data_ptr(), *dims)
        paged_launches += 1
    return out


def decode_attention_partials(q, k_cache, v_cache, lengths, *,
                              offset: int = 0,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """Flash-decode partials over one (sequence-shard-local) block.

    q: (B,H,D); caches: (B,Sl,KV,D); the global kv position of local row t
    is ``offset + t``; ``lengths``: () or (B,) int32, global. Returns fp32
    ``(num (B,KV,G,D), den (B,KV,G), m (B,KV,G))``, the contract of
    ``decode_attention_partials_ref``: row b sees local positions
    ``t <= lengths[b] - offset`` (and ``t > lengths[b] - offset - window``
    when windowed), which the kernel works out per row itself. The kernel
    runs at every Sl, unpadded (the reference takes its oracle below 64).
    """
    _check_common(q, k_cache, v_cache, "caches (B,Sl,KV,D)", window, softcap)
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    lengths = _lengths(lengths, b, q.device)
    if _on_cpu(q, k_cache, v_cache):
        return decode_attention_partials_ref(q, k_cache, v_cache, lengths,
                                             offset=offset, window=window,
                                             softcap=softcap)
    _check_cuda_inputs(q, q.dtype, [("q", q), ("k_cache", k_cache),
                                    ("v_cache", v_cache),
                                    ("lengths", lengths)])
    g = h // kv
    num = torch.empty((b, kv, g, d), dtype=torch.float32, device=q.device)
    den = torch.empty((b, kv, g), dtype=torch.float32, device=q.device)
    m = torch.empty((b, kv, g), dtype=torch.float32, device=q.device)
    _launch("decode_attention_partials_fwd", q, q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            num.data_ptr(), den.data_ptr(), m.data_ptr(),
            int(q.dtype == torch.bfloat16), b, t, h, kv, d, int(offset),
            window or 0, float(softcap or 0.0),
            _n_split(q, b * kv, t, window))
    global partials_launches
    partials_launches += 1
    return num, den, m
