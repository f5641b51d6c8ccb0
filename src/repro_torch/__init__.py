"""PyTorch/CUDA port of the ``repro`` package.

The JAX package under ``src/repro`` is the reference; this package mirrors
its module paths (``repro_torch.models.attention`` is the counterpart of
``repro.models.attention``) and is checked against it by the
``tests/test_torch_*.py`` suite. It imports torch, numpy and the standard
library only — never jax and never ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The hand-written CUDA kernels under ``kernels/`` are built from their
sources at first use (``kernels/build.py``).
"""
