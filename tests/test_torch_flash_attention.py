"""The port's flash-attention wrapper and plain version vs the JAX package's kernel.

The Pallas kernel runs in interpret mode on the CPU, as its own tests run it,
and the dense jnp reference beside it. Bounds are those of the JAX tests.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from frn_tpu.ops.flash_attention import _flash_forward, _reference_attention
from frn_tpu_torch import build
from frn_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(19)


def _inputs(b, n, d):
    return [RNG.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,n,d", [(1, 100, 32), (2, 513, 32), (1, 1100, 64), (1, 130, 32)])
def test_plain_matches_pallas_kernel_and_reference(b, n, d):
    g, th, ph = _inputs(b, n, d)
    want_ref = np.asarray(_reference_attention(jnp.asarray(g), jnp.asarray(th), jnp.asarray(ph)))
    want_kernel = np.asarray(_flash_forward(
        jnp.asarray(ph), jnp.asarray(th), jnp.asarray(g), block_q=128, block_k=256, interpret=True))
    got = fa.flash_attention_plain(
        torch.tensor(ph), torch.tensor(th), torch.tensor(g), block_k=256).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want_ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("block_k", [64, 100, 4096])
def test_plain_is_independent_of_key_tile(block_k):
    # ragged last tiles (100 does not divide 1100) and a single tile agree
    q, k, v = (torch.tensor(x) for x in _inputs(2, 1100, 32))
    want = fa.flash_attention_plain(q, k, v, block_k=1100)
    got = fa.flash_attention_plain(q, k, v, block_k=block_k)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


def test_cpu_tensor_routes_to_plain_without_launch():
    q, k, v = (torch.tensor(x) for x in _inputs(1, 300, 64))
    before = fa.flash_fwd_launches
    got = fa.flash_attention(q, k, v)
    assert fa.flash_fwd_launches == before
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(1, 64, 128), (1, 64, 16)])
def test_unsupported_head_dim_raises(shape):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)


def test_mismatched_shapes_raise():
    q = torch.zeros((1, 64, 32))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, torch.zeros((1, 65, 32)), q)


def test_import_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel build was started at import")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    module = importlib.reload(fa)
    assert module._lib is None
    q = torch.zeros((1, 8, 32))
    module.flash_attention(q, q, q)  # the CPU path needs no library either
    assert module._lib is None


def test_library_path_tracks_the_source():
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
