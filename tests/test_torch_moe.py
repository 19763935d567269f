"""The port's mixture-of-experts FFN against the JAX package.

The same NumPy-seeded tokens go through ``repro.models.moe`` and
``repro_torch.models.moe`` with the parameters the JAX package draws for
one MoE layer (``moe_decls``), carried over in the dtypes of the port's
declarations: dbrx-smoke (4 experts, top-2, no shared expert) and
llama4-maverick-smoke (8 experts, top-1, one shared expert):

- ``_router_topk``: the float32 router logits, the top-k expert ids
  (equal) and their softmax weights;
- ``moe_dense`` and ``moe_block`` (shared expert on and off);
- the declarations: the router float32 in a bf16 config, the shared
  expert under ``"shared"``, the shapes of the reference.

Tolerance: float32, max |port - JAX| <= 1e-5 * max |JAX| (both sum float32
products in another order); bf16, 1e-2 * max |JAX|: the expert products
round to bf16 on both sides, at points where XLA's CPU dot and PyTorch's
may round one element a bf16 ulp (2**-8 relative) apart, and the FFN
carries that through two more products.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.common import init_params as jax_init  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.common import cast_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b"]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    bound = tol * float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= bound, (err, bound)


@functools.lru_cache(maxsize=None)
def _layer(arch, dtype):
    """(JAX cfg, JAX params of one MoE layer, port cfg, port params, tokens
    x in both packages)."""
    jc = dataclasses.replace(jax_smoke(arch), dtype=getattr(jnp, dtype))
    pc = dataclasses.replace(get_smoke_config(arch),
                             dtype=getattr(torch, dtype))
    jf = jax_init(j_moe.moe_decls(jc), jax.random.PRNGKey(0))
    if dtype == "float32":          # the reference declares bf16 leaves
        jf = jax.tree.map(lambda a: a.astype(jnp.float32), jf)

    def carry(node, decl):
        if isinstance(node, dict):
            return {k: carry(v, decl[k]) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node.astype(jnp.float32))).to(
            decl.dtype)

    pf = carry(jf, moe.moe_decls(pc))
    if dtype == "float32":          # and so does the port
        pf = cast_tree(pf)
    x = np.random.RandomState(1).randn(2, 13, jc.d_model).astype(np.float32)
    return (jc, jf, pc, pf, jnp.asarray(x).astype(jc.dtype),
            torch.from_numpy(x).to(pc.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_jax(arch):
    jc, jf, pc, pf, jx, px = _layer(arch, "float32")
    jw, jidx, jlog = j_moe._router_topk(jx.reshape(-1, jc.d_model),
                                        jf["router"], jc.top_k)
    pw, pidx, plog = moe._router_topk(px.reshape(-1, pc.d_model),
                                      pf["router"], pc.top_k)
    assert plog.dtype == pw.dtype == torch.float32
    _close(plog, jlog, TOL["float32"])
    assert np.array_equal(pidx.numpy(), np.asarray(jidx))
    _close(pw, jw, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch, dtype):
    jc, jf, pc, pf, jx, px = _layer(arch, dtype)
    got = moe.moe_dense(pc, pf, px)
    assert got.dtype == px.dtype
    _close(got, j_moe.moe_dense(jc, jf, jx), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, dtype):
    """dbrx: routed experts only; maverick: plus the shared expert."""
    jc, jf, pc, pf, jx, px = _layer(arch, dtype)
    assert ("shared" in pf) == bool(pc.n_shared_experts) \
        == (arch != "dbrx-132b")
    got = moe.moe_block(pc, pf, px)
    assert got.dtype == px.dtype
    _close(got, j_moe.moe_block(jc, jf, jx), TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decls_match_the_reference(arch):
    """Same keys and shapes as the reference's declarations; the router
    float32 in the bf16 config, every other leaf bf16."""
    jd = j_moe.moe_decls(jax_smoke(arch))
    pd = moe.moe_decls(get_smoke_config(arch))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: d for k, v in tree.items()
                    for p, d in flat(v, prefix + (k,)).items()}
        return {prefix: tree}

    jf, pf = flat(jd), flat(pd)
    assert set(jf) == set(pf)
    for key, d in pf.items():
        assert d.shape == jf[key].shape, key
        want = torch.float32 if key == ("router",) else torch.bfloat16
        assert d.dtype == want, key
        assert np.dtype(jf[key].dtype).name == str(want)[len("torch."):]
