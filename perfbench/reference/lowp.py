"""The matmuls every reference runs through, in float32 or emulated fp8.

``Precision("fp32")`` multiplies in float32 with TF32 off (the reference).
``Precision("fp8")`` rounds both inputs of every matmul to float8 e4m3
first, with one scale per row of the left input and one per column of the
right input (amax to 448), then multiplies the rounded values in float32:
the reference computed one precision below the bfloat16 the
configurations state, which is the control of the comparison.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp32_only() -> None:
    """TF32 off: a float32 matmul on the card may otherwise run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to e4m3 with one scale per slice along
    ``dim`` (the reduction dim of the matmul it feeds), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r} not in ('fp32', 'fp8')")
        self.name = name
        fp32_only()

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (K, N) weight in float32, rounded once where it is fp8."""
        w = w.float()
        return round_fp8(w, -2) if self.name == "fp8" else w

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w`` for a weight ``w`` that :meth:`weight` prepared."""
        a = a.float()
        return (round_fp8(a, -1) if self.name == "fp8" else a) @ w

    def mm2(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` of two activations (attention's two matmuls)."""
        return self.mm(a, self.weight(b))
