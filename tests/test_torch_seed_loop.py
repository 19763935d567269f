"""The seed's per-iteration dual solve in the port against the JAX one.

``chip_smoke.seed_loop`` (the loop that phase 3e runs on the card, eager
and captured in a CUDA graph) steps ``ops.assign_step``, here its plain
version on the CPU, and updates the multipliers with tensor ops.  The
reference is ``benchmarks/bench_routing.py::_seed_per_iteration_launch``,
one jitted ``fori_loop`` over the JAX ``assign_step_kernel`` in interpret
mode.  Same numpy ``RandomState`` inputs, α 0.7, loads N/2, 150
iterations: ``x``, ``found`` and λ2 exact; λ1 within 1e-4 relative.  The
step's float32 sums go through XLA's reduction order on one side and the
kernel's block order on the other, and XLA and PyTorch round the update
``λ1 + 4·N·lr·(α − q)`` through other intermediates (C4 in ROADMAP.md): the
two λ1 trajectories part by a few ulps, measured at most 7.9e-6 relative.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from benchmarks.bench_routing import _seed_per_iteration_launch  # noqa: E402
from repro_torch.kernels.lagrangian_assign import ops as pops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ALPHA = 0.7
ITERS = 150
LAM1_RTOL = 1e-4      # C4: see the module docstring


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,m,seed", [(256, 6, 0), (1000, 6, 1), (512, 4, 2)])
def test_seed_loop_matches_jax(n, m, seed):
    rng = np.random.RandomState(seed)
    c = rng.rand(n, m).astype(np.float32)
    a = rng.rand(n, m).astype(np.float32)
    loads = np.full(m, n / 2.0, np.float32)
    before = pops.step_launches
    x, lam1, lam2, found = _chip_smoke().seed_loop(
        torch, pops.assign_step, torch.as_tensor(c), torch.as_tensor(a),
        ALPHA, torch.as_tensor(loads), ITERS)
    assert pops.step_launches == before          # the CPU runs no kernel
    jx, info = _seed_per_iteration_launch(jnp.asarray(c), jnp.asarray(a),
                                          ALPHA, jnp.asarray(loads),
                                          iters=ITERS)
    assert x.dtype == torch.int32
    assert np.array_equal(x.numpy(), np.asarray(jx))
    assert bool(found) and bool(info["feasible"])
    assert np.array_equal(lam2.numpy(), np.asarray(info["lambda2"]))
    want = float(info["lambda1"])
    assert abs(float(lam1) - want) <= LAM1_RTOL * abs(want)
