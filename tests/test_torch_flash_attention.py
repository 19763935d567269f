"""The port's flash attention against the JAX package.

``flash_attention_chunked`` (the CPU path of ``ops.flash_attention`` and the
plain version the CUDA kernel is held to on the card) and the port's
``flash_attention_ref`` against the JAX Pallas kernel in interpret mode and
the JAX ``flash_attention_ref``, at ``tests/test_kernels.py``'s five cases
and its bounds: 2e-5 in float32, 2e-2 in bf16 (bf16 inputs and outputs;
the chunked version rounds p to bf16 before the P.V product, the reference
does not).  Inputs are made with numpy from a seed and rounded to bf16 the
same way in both packages.  A ragged Sq (not a multiple of the kernel's
64-position query blocks nor of the JAX kernel's blocks) is held to both
references, and a ``q_offset`` case (a query block that continues a prefix)
to ``flash_attention_jnp``, which the JAX model runs.  The chunked
version at the kernel's step over keys padded to a multiple of it, with
the pad masked (``kv_valid``), is held to ``flash_attention_jnp``
without causality, at equal and at unequal query and key lengths (the
encoder-decoder's encoder and cross-attention).

The CUDA kernel has no CPU mode: its wrapper refuses CPU tensors here and
``chip_smoke.py`` holds it against the chunked version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_ref)
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    MAX_SMEM, flash_attention_cuda, query_block, smem_bytes, softmax_step)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_chunked, flash_attention_ref)

CASES = [   # b, s, h, kh, d, causal, window, dtype (tests/test_kernels.py)
    (2, 256, 4, 2, 64, True, 0, "float32"),
    (1, 512, 8, 8, 128, True, 128, "float32"),
    (2, 256, 4, 1, 64, False, 0, "float32"),
    (1, 256, 4, 4, 64, True, 0, "bfloat16"),
    (1, 128, 2, 1, 32, True, 32, "float32"),
]


def _inputs(b, sq, skv, h, kh, d, dtype, seed=0):
    """numpy float32 draws -> (torch tensors, jax arrays), both rounded to
    ``dtype`` by round-to-nearest-even."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(b, sq, h, d), rng.randn(b, skv, kh, d),
            rng.randn(b, skv, kh, d)]
    arrs = [a.astype(np.float32) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    return tt, jj


def _err(got, want):
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("b,s,h,kh,d,causal,window,dtype", CASES)
def test_plain_versions_match_jax_kernel_and_ref(b, s, h, kh, d, causal,
                                                 window, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(b, s, s, h, kh, d, dtype)
    kern = jax_flash(jq, jk, jv, causal=causal, window=window, bq=64, bk=128)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    launches = ops.launches
    chunked = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launches == launches          # a CPU tensor launches nothing
    assert chunked.dtype == q.dtype and chunked.shape == q.shape
    dense = flash_attention_ref(q, k, v, causal=causal, window=window)
    for got in (chunked, dense):
        for want in (kern, ref):
            assert _err(got, want) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_query_length(dtype):
    """Sq = Skv = 200: no multiple of the CUDA kernel's 64-position query
    blocks or 64-position key tiles; a sliding window masks the head of
    the sequence for the last rows."""
    (q, k, v), (jq, jk, jv) = _inputs(1, 200, 200, 8, 2, 32, dtype, seed=1)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = flash_attention_chunked(q, k, v, causal=True, window=96)
    assert _err(got, jax_ref(jq, jk, jv, causal=True, window=96)) < tol
    assert _err(got, flash_attention_jnp(jq, jk, jv, causal=True,
                                         window=96)) < tol
    assert _err(flash_attention_ref(q, k, v, causal=True, window=96),
                jax_ref(jq, jk, jv, causal=True, window=96)) < tol


@pytest.mark.parametrize("window", [0, 40])
def test_q_offset_matches_flash_attention_jnp(window):
    """A 48-row query block at positions 112..159 against 160 keys."""
    (q, k, v), (jq, jk, jv) = _inputs(2, 48, 160, 4, 2, 16, "float32",
                                      seed=2)
    got = flash_attention_chunked(q, k, v, causal=True, window=window,
                                  q_offset=112)
    want = flash_attention_jnp(jq, jk, jv, causal=True, window=window,
                               q_offset=112)
    assert _err(got, want) < 2e-5
    assert torch.equal(ops.flash_attention(q, k, v, causal=True,
                                           window=window, q_offset=112), got)


def test_cuda_wrapper_refuses_cpu_tensors():
    (q, k, v), _ = _inputs(1, 8, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)


@pytest.mark.parametrize("h,kh,d,dtype,block,fits,step", [
    (32, 8, 120, torch.bfloat16, 32, True, 64),     # h2o-danube-3-4b
    (32, 8, 120, torch.float32, 64, True, 32),
    (8, 4, 256, torch.bfloat16, 64, True, 64),      # gemma3-4b
    (8, 4, 256, torch.float32, 64, False, 32),
    (4, 2, 16, torch.float32, 128, True, 32),       # the smoke configs
    (4, 2, 16, torch.bfloat16, 64, True, 64),
    (64, 8, 128, torch.bfloat16, 16, True, 64),     # qwen2-72b
    (32, 32, 96, torch.bfloat16, 128, True, 64),    # phi-3-vision-4.2b
    (25, 5, 64, torch.bfloat16, 25, True, 64),      # hymba-1.5b (G 5)
    (25, 5, 64, torch.float32, 51, True, 32),
    (48, 8, 128, torch.bfloat16, 21, True, 64),     # dbrx-132b (G 6)
    (40, 8, 128, torch.bfloat16, 25, True, 64),     # llama4-maverick (G 5)
    (16, 16, 64, torch.bfloat16, 128, True, 64),    # seamless-m4t (G 1)
    (16, 16, 64, torch.float32, 256, True, 32),
])
def test_kernel_geometry(h, kh, d, dtype, block, fits, step):
    """Query positions per CTA (bf16: 128 rows on the tensor cores; float32:
    512 threads of 16 or 8 rows a warp), whether one CTA's shared memory
    fits (the wrapper refuses the shapes that do not) and the softmax
    step."""
    assert query_block(h, kh, d, dtype) == block
    assert (smem_bytes(d, dtype) <= MAX_SMEM) == fits
    assert softmax_step(d, dtype) == step


@pytest.mark.parametrize("b,sq,h,kh,d,window,q_offset", [
    (1, 150, 8, 2, 120, 4096, 0),       # h2o-danube-3-4b heads (G 4)
    (1, 1100, 2, 1, 256, 1024, 0),      # gemma3-4b heads (G 2), window
    (2, 70, 8, 2, 120, 0, 90),          # a block that continues a prefix
    (1, 300, 10, 2, 64, 100, 0),        # hymba-1.5b heads (G 5), window
])
def test_chunked_at_kernel_step_matches_flash_attention_jnp(
        b, sq, h, kh, d, window, q_offset):
    """The object the bf16 kernel is held to on the card: the chunked plain
    version at the kernel's softmax step, keys zero-padded to a multiple
    of it (causality masks the pad), against the JAX model's
    ``flash_attention_jnp`` at the bf16 bound."""
    skv = q_offset + sq
    (q, k, v), (jq, jk, jv) = _inputs(b, sq, skv, h, kh, d, "bfloat16",
                                      seed=3)
    step = softmax_step(d, torch.bfloat16)
    pad = -skv % step
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (k, v))
    got = flash_attention_chunked(q, kp, vp, causal=True, window=window,
                                  q_offset=q_offset, kv_chunk=step)
    want = flash_attention_jnp(jq, jk, jv, causal=True, window=window,
                               q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _err(got, want) < 2e-2


@pytest.mark.parametrize("sq,skv", [(150, 150), (70, 150)])
def test_chunked_at_kernel_step_masks_the_pad_without_causality(sq, skv):
    """Non-causal attention (an encoder, and cross-attention with Sq !=
    Skv) at the kernel's softmax step: the zero-padded keys are masked by
    ``kv_valid`` and the result is ``flash_attention_jnp``'s at the bf16
    bound; unmasked, the pad takes a share of every row's softmax."""
    (q, k, v), (jq, jk, jv) = _inputs(2, sq, skv, 4, 4, 64, "bfloat16",
                                      seed=4)
    step = softmax_step(64, torch.bfloat16)
    pad = -skv % step
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (k, v))
    want = flash_attention_jnp(jq, jk, jv, causal=False)
    got = flash_attention_chunked(q, kp, vp, causal=False, kv_chunk=step,
                                  kv_valid=skv)
    assert got.shape == q.shape and _err(got, want) < 2e-2
    leaky = flash_attention_chunked(q, kp, vp, causal=False, kv_chunk=step)
    assert _err(leaky, want) > 0.1
