"""The port's flash-attention wrappers and plain versions vs the JAX package's kernels.

The Pallas kernels run in interpret mode on the CPU, as their own tests run
them, and the dense jnp reference beside them. Bounds are those of the JAX
tests: forward atol 2e-5 rtol 1e-4; logsumexp and backward atol 2e-4 rtol 1e-3.
"""

import ctypes
import functools
import importlib
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from frn_tpu.ops.flash_attention import _flash_backward, _flash_forward, _reference_attention
from frn_tpu_torch import build
from frn_tpu_torch.ops import attention
from frn_tpu_torch.ops import flash_attention as fa
from frn_tpu_torch.ops import stem

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


@pytest.mark.parametrize("shape", [(1, 64, 128), (1, 64, 24)])
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
    assert module._lib is None and module._bwd_lib is None
    q = torch.zeros((1, 8, 32))
    module.flash_attention(q, q, q)  # the CPU path needs no library either
    o, lse = module.flash_attention(q, q, q, return_lse=True)
    module.flash_attention_backward(q, q, q, o, lse, q)
    assert module._lib is None and module._bwd_lib is None
    assert module._f32_lib is None and module._bwd_f32_lib is None


def test_library_path_tracks_the_source():
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.SOURCES == ("flash_attention", "flash_attention_bwd", "flash_attention_int8",
                             "stem", "flash_attention_f32", "flash_attention_bwd_f32")
    assert build.library_path("flash_attention_bwd_f32").name.startswith("flash_attention_bwd_f32-")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()


@pytest.mark.parametrize("header", ["flash_common.cuh", "flash_sm90.cuh"])
def test_library_path_covers_the_shared_header(tmp_path, monkeypatch, header):
    # every source rebuilds when any shared header changes
    for src in [build.CSRC / "flash_attention.cu", *build.CSRC.glob("*.cuh")]:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("flash_attention")
    (tmp_path / header).write_text("// edited\n")
    assert build.library_path("flash_attention") != before


# ------------------------------------------------------------ logsumexp and backward

BWD_SHAPES = [(1, 200, 32), (1, 256, 32), (2, 131, 16)]
# the Hopper forward's block edges (64-key tiles; 64- and 128-row query
# blocks): one partial key tile with whole idle warps, an exact fit, one
# ragged row past it, a ragged tile after full ones, at every head dim
FWD_EDGE_SHAPES = [(2, 40, 8), (2, 40, 16), (2, 40, 32), (2, 40, 64), (2, 128, 32), (2, 129, 32),
                   (1, 200, 64)]


def _jax_forward_backward(q, k, v, do):
    o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                            block_k=128, interpret=True, return_lse=True)
    grads = _flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                            jnp.asarray(do), block_q=128, block_k=128, interpret=True)
    return [np.asarray(x) for x in (o, lse, *grads)]


@pytest.mark.parametrize("b,n,d", BWD_SHAPES + FWD_EDGE_SHAPES)
def test_plain_lse_matches_pallas_kernel(b, n, d):
    q, k, v = _inputs(b, n, d)
    want_o, want_lse = (np.asarray(x) for x in _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128, interpret=True,
        return_lse=True))
    o, lse = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      block_k=64, return_lse=True)
    assert lse.shape == (b, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-4, rtol=1e-3)


# B, N, d and the key block (block_q the same) of the bf16 denominator check
BF16_DENOMINATOR_SHAPES = [(2, 256, 32, 128), (2, 300, 16, 128), (1, 512, 64, 128), (2, 200, 8, 64)]


@pytest.mark.parametrize("b,n,d,block", BF16_DENOMINATOR_SHAPES)
def test_plain_sums_the_bf16_weights_into_the_denominator(b, n, d, block):
    # At bf16 the JAX kernel sums the bf16-rounded p through the ones lane of
    # V (frn_tpu/ops/flash_attention.py, _flash_q_group); summing the f32 p
    # instead makes 2.2-2.7% of the bf16 outputs differ at these inputs. What
    # is left is exp and summation order
    rng = np.random.default_rng(23)
    q, k, v = (rng.normal(0, 0.5, (b, n, d)).astype(np.float32) for _ in range(3))
    want_o, want_lse = (np.asarray(x, np.float32) for x in _flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), block_q=block, block_k=block,
        interpret=True, return_lse=True))
    o, lse = fa.flash_attention_plain(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                                      block_k=block, return_lse=True)
    differ = np.mean(o.float().numpy() != want_o)
    assert differ < 5e-3, f"{differ:.2%} of the bf16 outputs differ"
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=3e-4, rtol=0)


@pytest.mark.parametrize("b,n,d", BWD_SHAPES + FWD_EDGE_SHAPES)
def test_plain_backward_matches_pallas_kernels(b, n, d):
    q, k, v, do = _inputs(b, n, d) + _inputs(b, n, d)[:1]
    _, _, want_dq, want_dk, want_dv = _jax_forward_backward(q, k, v, do)
    t = [torch.tensor(x) for x in (q, k, v, do)]
    o, lse = fa.flash_attention_plain(*t[:3], return_lse=True)
    dq, dk, dv = fa.flash_attention_backward_plain(*t[:3], o, lse, t[3], block=64)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_plain_backward_is_finite_where_lse_is_below_minus_88():
    # Scores shifted far below zero at a ragged N (the last 64-row tile holds
    # 3 rows): a zero-filled key past N would give s = 0 and P = exp(-lse) =
    # inf, so the kernels mask those keys; the plain version never sees them,
    # and it is the function the mask must keep: finite, and the dense VJP
    b, n, d = 2, 131, 16
    q, k, v, do = (RNG.normal(0, 0.5, (b, n, d)).astype(np.float32) for _ in range(4))
    q[..., 0], k[..., 0] = 10.0, -10.0  # s = -100 + O(1)
    q, k, v, do = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(q, k, v, block_k=64, return_lse=True)
    assert lse.max() < -88 and torch.isinf(torch.exp(-lse)).all()
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, do, block=64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = attention.nonlocal_attention(leaves[2], leaves[1], leaves[0], chunk=64)
    want = torch.autograd.grad(ref, leaves, do)
    torch.testing.assert_close(o, ref, atol=2e-5, rtol=1e-4)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("source,bind,name", [
    ("flash_attention", fa.bind_forward, "frn_flash_fwd_bf16"),
    ("flash_attention", fa.bind_forward, "frn_flash_fwd_bf16exp_bf16"),
    ("flash_attention_bwd", fa.bind_backward, "frn_flash_bwd_dq_bf16"),
    ("flash_attention_bwd", fa.bind_backward, "frn_flash_bwd_dkv_bf16"),
    ("flash_attention_int8", fa.bind_int8, "frn_flash_int8"),
    ("flash_attention_int8", fa.bind_int8, "frn_flash_int8_prepass"),
    ("stem", stem.bind_stem, "frn_stem_conv_bn_relu"),
    ("flash_attention_f32", fa.bind_f32, "frn_flash_fwd_f32"),
    ("flash_attention_bwd_f32", functools.partial(fa.bind_backward, dtype="f32"),
     "frn_flash_bwd_dq_f32"),
    ("flash_attention_bwd_f32", functools.partial(fa.bind_backward, dtype="f32"),
     "frn_flash_bwd_dkv_f32"),
])
def test_entry_points_take_the_arguments_ctypes_declares(source, bind, name):
    # ctypes passes what argtypes declares, so a C signature that gains or
    # loses an argument, or turns a pointer into an int, would go unnoticed
    # until the card: each extern "C" signature against its binding
    src = (build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.split()[0] == "int" for p in params)
    names = ("frn_flash_fwd_bf16", "frn_flash_fwd_bf16exp_bf16", "frn_flash_bwd_dq_bf16",
             "frn_flash_bwd_dkv_bf16", "frn_flash_int8", "frn_flash_int8_prepass",
             "frn_stem_conv_bn_relu", "frn_flash_fwd_f32", "frn_flash_bwd_dq_f32",
             "frn_flash_bwd_dkv_f32")
    lib = bind(types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names}))
    assert getattr(lib, name).argtypes == want
    assert getattr(lib, name).restype is ctypes.c_int


@pytest.mark.parametrize("block", [32, 100, 1100])
def test_plain_backward_is_independent_of_tile(block):
    # ragged last tiles (100 does not divide 300) and a single tile agree
    q, k, v, do = (torch.tensor(x) for x in _inputs(2, 300, 16) + _inputs(2, 300, 16)[:1])
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do, block=300)
    got = fa.flash_attention_backward_plain(q, k, v, o, lse, do, block=block)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("b,n,d", [(1, 96, 16), (2, 131, 8), (1, 300, 32)])
def test_autograd_function_matches_dense_route(b, n, d):
    # FlashAttentionFn on the CPU (plain forward with lse, plain backward)
    # against autograd through the dense route; (q, k, v) = (phi, theta, g)
    q, k, v, do = (torch.tensor(x) for x in _inputs(b, n, d) + _inputs(b, n, d)[:1])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    dense = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = attention.nonlocal_attention(dense[2], dense[1], dense[0], chunk=64)
    want = torch.autograd.grad(ref, dense, do)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)


def test_cpu_backward_wrappers_route_to_plain_without_launch():
    q, k, v, do = (torch.tensor(x) for x in _inputs(1, 130, 16) + _inputs(1, 130, 16)[:1])
    counts = (fa.flash_fwd_lse_launches, fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, o, lse, do)
    assert counts == (fa.flash_fwd_lse_launches, fa.flash_bwd_dq_launches,
                      fa.flash_bwd_dkv_launches)
    want = fa.flash_attention_backward_plain(q, k, v, o, lse, do)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_kernel_route_refuses_inputs_that_need_a_gradient(monkeypatch):
    # on the card the kernel's output has no grad_fn: a direct call with an
    # input that requires grad raises instead of returning a detached tensor
    monkeypatch.setattr(fa, "_on_kernel_device", lambda q: True)
    q = torch.zeros((1, 64, 32), dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros((1, 64, 32), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        fa.flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, k, k.float())  # past the gradient check, at the dtype check


def test_backward_checks_row_statistics_shape():
    q = torch.zeros((1, 64, 16))
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, q, q, q, torch.zeros((1, 63)), torch.zeros((1, 64)))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_bwd_dkv(q, q, q, torch.zeros((1, 64, 32)), torch.zeros((1, 64)),
                         torch.zeros((1, 64)))


# ------------------------------------------------------------ f32 forward (B1 at f32)


@pytest.mark.parametrize("b,n,d", [(1, 300, 64), (2, 131, 8), (1, 517, 32)])
def test_plain_f32_keeps_p_in_f32(b, n, d):
    # at f32 the plain version's p is never rounded: it equals the exact
    # softmax with an f32 accumulator (as the JAX kernel's with f32 V, whose
    # ones lane sums the same unrounded p), at the kernel's tile of 64 keys
    # and at 32 (the f32 kernel's tile at d 64) alike
    q, k, v = (torch.tensor(x) for x in _inputs(b, n, d))
    want = torch.softmax(torch.bmm(q.double(), k.double().transpose(1, 2)), -1) @ v.double()
    for block in (64, 32):
        got = fa.flash_attention_plain(q, k, v, block_k=block)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, atol=2e-5, rtol=1e-4)
    want_kernel = np.asarray(_flash_forward(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                            jnp.asarray(v.numpy()), block_q=128, block_k=128,
                                            interpret=True))
    np.testing.assert_allclose(fa.flash_attention_plain(q, k, v).numpy(), want_kernel, atol=2e-5,
                               rtol=1e-4)


def _mock_kernels(monkeypatch):
    """Every wrapper takes its kernel route, with each library's entry points
    named by a string and each launch recorded as (entry, pointer args that
    are null, trailing int args) instead of run."""
    calls = []
    monkeypatch.setattr(fa, "_on_kernel_device", lambda q: True)
    monkeypatch.setattr(fa, "_f32_library", lambda: types.SimpleNamespace(frn_flash_fwd_f32="f32"))
    monkeypatch.setattr(fa, "_library", lambda: types.SimpleNamespace(frn_flash_fwd_bf16="bf16"))
    monkeypatch.setattr(fa, "_bwd_library", lambda: types.SimpleNamespace(
        frn_flash_bwd_dq_bf16="dq_bf16", frn_flash_bwd_dkv_bf16="dkv_bf16"))
    monkeypatch.setattr(fa, "_bwd_f32_library", lambda: types.SimpleNamespace(
        frn_flash_bwd_dq_f32="dq_f32", frn_flash_bwd_dkv_f32="dkv_f32"))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: calls.append(
        (fn, tuple(i for i, a in enumerate(args[:-3]) if a is None), args[-3:])))
    return calls


F32_COUNTERS = ("flash_fwd_f32_launches", "flash_fwd_lse_f32_launches", "flash_fwd_launches",
                "flash_fwd_lse_launches", "flash_bwd_dq_f32_launches", "flash_bwd_dkv_f32_launches",
                "flash_bwd_dq_launches", "flash_bwd_dkv_launches")


def _counter_moves(before):
    return {name: getattr(fa, name) - n for name, n in before.items() if getattr(fa, name) != n}


def test_f32_inputs_route_to_the_f32_kernel(monkeypatch):
    # on the card an f32 forward launches the f32 kernel: without lse (a null
    # lse pointer, the inference counter) and with it (a non-null lse, the
    # training counter); an input that requires grad raises as before
    calls = _mock_kernels(monkeypatch)
    q = torch.zeros((2, 64, 32))
    before = {name: getattr(fa, name) for name in F32_COUNTERS}
    out = fa.flash_attention(q, q, q)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert calls == [("f32", (4,), (2, 64, 32))]  # q, k, v, o, then a null lse
    assert _counter_moves(before) == {"flash_fwd_f32_launches": 1}
    o, lse = fa.flash_attention(q, q, q, return_lse=True)
    assert o.dtype == torch.float32 and lse.shape == (2, 64) and lse.dtype == torch.float32
    assert calls[-1] == ("f32", (), (2, 64, 32))
    assert _counter_moves(before) == {"flash_fwd_f32_launches": 1, "flash_fwd_lse_f32_launches": 1}
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(RuntimeError, match="FlashAttentionFn"):
        fa.flash_attention(q.clone().requires_grad_(), q, q)
    qb = q.to(torch.bfloat16)
    fa.flash_attention(qb, qb, qb)
    assert calls[-1] == ("bf16", (4,), (2, 64, 32))
    assert _counter_moves(before) == {"flash_fwd_f32_launches": 1, "flash_fwd_lse_f32_launches": 1,
                                      "flash_fwd_launches": 1}


@pytest.mark.parametrize("dtype,dq,dkv", [(torch.float32, "dq_f32", "dkv_f32"),
                                          (torch.bfloat16, "dq_bf16", "dkv_bf16")])
def test_backward_arguments_route_by_dtype(monkeypatch, dtype, dq, dkv):
    # all-f32 backward arguments reach the f32 entries, all-bf16 ones the bf16
    # entries, each counted on its own counter; lse and delta are f32 in both
    calls = _mock_kernels(monkeypatch)
    q = torch.zeros((2, 131, 16), dtype=dtype)
    rows = torch.zeros((2, 131))
    before = {name: getattr(fa, name) for name in F32_COUNTERS}
    got_dq = fa.flash_bwd_dq(q, q, q, q, rows, rows)
    got_dk, got_dv = fa.flash_bwd_dkv(q, q, q, q, rows, rows)
    assert all(x.shape == q.shape and x.dtype == dtype for x in (got_dq, got_dk, got_dv))
    assert calls == [(dq, (), (2, 131, 16)), (dkv, (), (2, 131, 16))]
    suffix = "_f32" if dtype == torch.float32 else ""
    assert _counter_moves(before) == {f"flash_bwd_dq{suffix}_launches": 1,
                                      f"flash_bwd_dkv{suffix}_launches": 1}


@pytest.mark.parametrize("odd", ["k", "v", "do", "lse", "delta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_mixed_dtypes_raise(monkeypatch, odd, dtype):
    # one argument off the kernels' types (q's dtype for the matrices, f32
    # for the row statistics) raises before any launch
    calls = _mock_kernels(monkeypatch)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    args = {name: torch.zeros((1, 64, 8), dtype=dtype) for name in ("q", "k", "v", "do")}
    args.update(lse=torch.zeros((1, 64)), delta=torch.zeros((1, 64)))
    args[odd] = args[odd].to(other if odd in ("k", "v", "do") else torch.float16)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(TypeError, match=odd):
            fn(*args.values())
    assert calls == []


def test_nonlocal_attention_trains_at_f32_on_the_kernel_route(monkeypatch):
    # on the card an f32 input that requires grad takes FlashAttentionFn: the
    # f32 forward with lse, then both f32 backward kernels (the libraries are
    # mocked, so the values are not checked here: chip_smoke.py holds them)
    calls = _mock_kernels(monkeypatch)
    monkeypatch.setattr(attention, "_kernel_route", lambda g: True)
    g, theta, phi = (torch.zeros((2, 64, 32), requires_grad=True) for _ in range(3))
    out = attention.nonlocal_attention(g, theta, phi)
    assert out.requires_grad and [c[0] for c in calls] == ["f32"] and calls[0][1] == ()
    out.sum().backward()
    assert [c[0] for c in calls] == ["f32", "dq_f32", "dkv_f32"]
    assert all(x.grad is not None and x.grad.dtype == torch.float32 for x in (g, theta, phi))
    with pytest.raises(RuntimeError, match="inference only"):
        attention.nonlocal_attention(g, theta, phi, exp_bf16=True)


def test_f32_library_is_built_lazily(monkeypatch):
    monkeypatch.setattr(fa, "_f32_lib", None)
    loaded = []
    monkeypatch.setattr(build, "load", lambda name: loaded.append(name) or types.SimpleNamespace(
        frn_flash_fwd_f32=types.SimpleNamespace()))
    lib = fa._f32_library()
    assert loaded == ["flash_attention_f32"] and lib.frn_flash_fwd_f32.restype is ctypes.c_int
    assert fa._f32_library() is lib and loaded == ["flash_attention_f32"]


def test_f32_backward_library_is_built_lazily(monkeypatch):
    monkeypatch.setattr(fa, "_bwd_f32_lib", None)
    loaded = []
    monkeypatch.setattr(build, "load", lambda name: loaded.append(name) or types.SimpleNamespace(
        frn_flash_bwd_dq_f32=types.SimpleNamespace(), frn_flash_bwd_dkv_f32=types.SimpleNamespace()))
    lib = fa._bwd_f32_library()
    assert loaded == ["flash_attention_bwd_f32"]
    assert lib.frn_flash_bwd_dq_f32.restype is lib.frn_flash_bwd_dkv_f32.restype is ctypes.c_int
    assert fa._bwd_f32_library() is lib and loaded == ["flash_attention_bwd_f32"]
