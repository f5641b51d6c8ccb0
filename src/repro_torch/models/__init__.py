"""Model substrate in PyTorch: counterpart of ``repro.models``.

Re-exports are lazy (PEP 562), as in the reference: importing
``repro_torch.models`` does not import the family modules.
"""
_COMMON = ("AxSpec", "LayerSpec", "ModelConfig", "MoEConfig", "RunConfig",
           "SSMConfig", "abstract_params", "init_params", "param_bytes",
           "param_count")
_ZOO = ("Model", "SkipCell", "build")

__all__ = sorted(_COMMON + _ZOO)


def __getattr__(name):
    if name in _COMMON:
        from repro_torch.models import common
        return getattr(common, name)
    if name in _ZOO:
        from repro_torch.models import model_zoo
        return getattr(model_zoo, name)
    raise AttributeError(
        f"module 'repro_torch.models' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
