"""Public wrapper for the hand-written decode-attention kernel.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``
(the dense, non-quantized entry; the int8, paged and partials variants
are still to be ported, ROADMAP Queue 2). For CUDA tensors it always
launches the CUDA kernel (``decode_attention.cu``) at every cache length:
the reference's below-64-position fallback is not carried over and T
needs no padding. For CPU tensors, and only for them, it runs the plain
version (``ref.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      row_lengths)

SOURCE = Path(__file__).with_name("decode_attention.cu")
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches; callers reset it to count one run


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_inputs(q, k_cache, v_cache, lengths):
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"{name} is on {x.device}: the kernel takes q, the caches "
                f"and lengths on one CUDA device (CPU tensors take the "
                f"plain version)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"loads 16 bytes at a time)")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None):
    """q: (B,H,D); caches: (B,T,KV,D); lengths: () or (B,) int32.

    Returns (B,H,D); row b attends kv positions j <= lengths[b], and
    j > lengths[b] - window when a window is set. A length at or past T
    sees every position (the reference's clamped-write semantics).
    """
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,H,D) and caches (B,T,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    if min(b, t, h) < 1:
        raise ValueError(f"empty decode attention: q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    lengths = row_lengths(lengths, b, q.device).contiguous()
    if all(x.device.type == "cpu" for x in (q, k_cache, v_cache)):
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, softcap=softcap)
    _check_cuda_inputs(q, k_cache, v_cache, lengths)
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, t, h, kv, d, window or 0,
            float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
