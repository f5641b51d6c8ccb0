"""Hand-written Hopper kernels, one package per TPU kernel of the reference.

Each follows the layout ``repro/kernels/__init__.py`` asks for: the kernel
source (``<name>.cu``), ``ops.py`` (the wrapper: checks, padding, launch
count) and ``ref.py`` (the plain torch version). ``build.py`` compiles the
sources with ``nvcc`` at first use.
"""
