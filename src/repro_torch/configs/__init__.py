"""Architecture configs: one module per assigned arch + the paper's model.

Re-exports are lazy (PEP 562): importing ``repro_torch.configs`` doesn't import
the registry (and with it every arch module), so a broken single-arch
config can't break consumers that never touch it — and test collection
can't be zeroed out by one bad import.
"""
_REGISTRY = ("ARCHS", "ASSIGNED", "get", "reduce_for_smoke", "smoke")

__all__ = sorted(_REGISTRY)


def __getattr__(name):
    if name in _REGISTRY:
        from repro_torch.configs import registry
        return getattr(registry, name)
    raise AttributeError(
        f"module 'repro_torch.configs' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
