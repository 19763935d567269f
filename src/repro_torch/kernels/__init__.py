"""Hand-written CUDA kernels (built from ``repro_torch/csrc`` at first use)
with their plain PyTorch versions, one package per TPU kernel family."""


def promoted(fn):
    """``fn(q, k, v, ...)`` with q, k and v in the one dtype JAX promotes
    them to (bf16 queries against float32 keys: all float32), its result
    in q's dtype: an attention entry whose kernel takes one dtype.  A call
    whose three share a dtype passes straight through."""
    import functools

    import torch

    @functools.wraps(fn)
    def call(q, k, v, *args, **kw):
        if q.dtype == k.dtype == v.dtype:
            return fn(q, k, v, *args, **kw)
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        return fn(q.to(dt), k.to(dt), v.to(dt), *args, **kw).to(q.dtype)

    return call
