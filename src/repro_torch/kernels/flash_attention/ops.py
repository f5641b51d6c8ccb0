"""Public wrapper for the hand-written flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``. For
CUDA tensors it always launches the CUDA kernel (``flash_attention.cu``),
at every size, after padding S and T to the kernel's block multiples and
checking device, dtype, shape and contiguity. For CPU tensors, and only for
them, it runs the plain version (``ref.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).with_name("flash_attention.cu")
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches; callers reset it to count one run


def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _pad_to(x, axis: int, mult: int):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths), pad


def _check_cuda_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"{name} is on {x.device}: the kernel takes q, k and v on "
                f"one CUDA device (CPU tensors take the plain version)")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Public entry. q: (B,S,H,D); k,v: (B,T,KV,D); returns (B,S,H,D)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D) and k, v (B,T,KV,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    if min(b, s, t, h) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    _check_cuda_inputs(q, k, v)
    lib = _library()
    qp, pad_q = _pad_to(q, 1, lib.flash_attention_block_q())
    kp, _ = _pad_to(k, 1, lib.flash_attention_block_k())
    vp, _ = _pad_to(v, 1, lib.flash_attention_block_k())
    out = torch.empty_like(qp)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, qp.shape[1], kp.shape[1], h,
            kv, d, t, int(causal), window or 0, float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out[:, :s] if pad_q else out
