"""The port's native host library against frn_tpu's, on the CPU.

The port builds its own copy of the C++ source
(``frn_tpu_torch/native/voxelize.cpp``) into ``frn_tpu_torch/_build/``; each
of its four entry points equals ``frn_tpu.utils.native``'s bit for bit on the
same arrays (the same source, the same compiler and flags). The port's
``voxelize_events_np`` equals frn_tpu's with the library and without it
(``FRN_DISABLE_NATIVE``), at the atol 1e-5 of ``tests/test_data.py:76``;
and the native scatter equals the numpy bincount exactly (sums of +-1 in
f32).
"""

import os

import numpy as np
import pytest

import frn_tpu.utils.native as jnative
from frn_tpu.ops.voxelize import voxelize_events_np as j_voxelize_events_np
from frn_tpu_torch.ops import voxelize as tvoxelize
from frn_tpu_torch.utils import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs():
    lib, jlib = tnative.get_lib(), jnative.get_lib()
    assert lib is not None and jlib is not None
    return lib, jlib


def _events(n=20_000, h=48, w=64, seed=0, overflow=True):
    rng = np.random.default_rng(seed)
    hi_x, hi_y = (w + 5, h + 5) if overflow else (w, h)
    x = rng.integers(0, hi_x, n).astype(np.int64)
    y = rng.integers(0, hi_y, n).astype(np.int64)
    t = np.sort(rng.integers(0, 50_000, n)).astype(np.int64)
    p = rng.integers(0, 2, n).astype(np.int8)
    return x, y, t, p


def test_builds_the_ports_own_source_into_build(libs):
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.name.startswith("libfrn_native-")
    assert str(tnative.SOURCE) == os.path.join(ROOT, "frn_tpu_torch", "native", "voxelize.cpp")
    assert path.is_file() and tnative.build() == path
    assert os.path.realpath(libs[0]._name) == os.path.realpath(path)


def test_voxelize_entry_point_equals_jax(libs):
    x, y, t, p = _events()
    rng = np.random.default_rng(1)
    t_bin = rng.integers(-1, 6, len(x))  # out-of-range bins are skipped by both
    pol = rng.choice([-1.0, 1.0], len(x)).astype(np.float32)
    got = tnative.native_voxelize(x, y, t_bin, pol, 5, 48, 64)
    want = jnative.native_voxelize(x, y, t_bin, pol, 5, 48, 64)
    assert got.dtype == np.float32 and got.shape == (5, 48, 64)
    np.testing.assert_array_equal(got, want)


def test_voxelize_raw_entry_point_equals_jax(libs):
    x, y, t, p = _events(seed=2)
    p = np.where(p > 0, 1, -1).astype(np.int8)
    got = tnative.native_voxelize_raw(x, y, t, p, 5, 48, 64)
    np.testing.assert_array_equal(got, jnative.native_voxelize_raw(x, y, t, p, 5, 48, 64))
    assert np.abs(got).sum() > 0
    assert not tnative.native_voxelize_raw(x[:0], y[:0], t[:0], p[:0], 5, 48, 64).any()


@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_event_subsample_entry_point_equals_jax(libs, threshold):
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(-1, 64, 5000), rng.uniform(-1, 48, 5000)], 1).astype(np.float32)
    pol = rng.choice([-1.0, 1.0], 5000).astype(np.float32)
    pos_before = pos.copy()
    got_pos, got_mask = tnative.native_event_subsample(pos, pol, 48, 64, threshold)
    want_pos, want_mask = jnative.native_event_subsample(pos, pol, 48, 64, threshold)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_pos, want_pos)
    assert 0 < got_mask.sum() < len(pos)
    np.testing.assert_array_equal(pos, pos_before)  # the caller's array is not written


@pytest.mark.parametrize("scale", [1.0, 20.0])
def test_tanh_normalize_entry_point_equals_jax(libs, scale):
    """Below the threshold the grid is left as it is; above it every value
    is squashed (the same libm tanh in both)."""
    v = (np.random.default_rng(4).normal(size=(5, 48, 64)) * scale).astype(np.float32)
    got = tnative.native_tanh_normalize(v.copy())
    np.testing.assert_array_equal(got, jnative.native_tanh_normalize(v.copy()))
    if scale == 1.0 and np.abs(v).max() <= 5.0:
        np.testing.assert_array_equal(got, v)
    else:
        np.testing.assert_allclose(got, np.tanh(v / 5.0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("overflow", [False, True])
def test_voxelize_events_np_equals_jax_with_and_without_the_library(libs, monkeypatch, overflow):
    x, y, t, p = _events(seed=5, overflow=overflow)
    with_lib = tvoxelize.voxelize_events_np(x, y, t, p, 5, 48, 64)
    np.testing.assert_allclose(with_lib, j_voxelize_events_np(x, y, t, p, 5, 48, 64), atol=1e-5)

    monkeypatch.setenv("FRN_DISABLE_NATIVE", "1")
    for module in (tnative, jnative):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_tried", False)
    assert tnative.get_lib() is None and tnative.native_voxelize(x, y, t, p, 5, 48, 64) is None
    without = tvoxelize.voxelize_events_np(x, y, t, p, 5, 48, 64)
    np.testing.assert_allclose(without, j_voxelize_events_np(x, y, t, p, 5, 48, 64), atol=1e-5)
    # the native scatter and the numpy bincount: the same f32 sums of +-1
    np.testing.assert_array_equal(with_lib, without)


def test_a_missing_compiler_gives_none(monkeypatch, tmp_path):
    """Where g++ is absent the build raises with the reason, and ``get_lib``
    (hence every entry point) returns None, as frn_tpu's does."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.delenv("FRN_DISABLE_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.build()
    assert tnative.get_lib() is None
    assert tnative.native_tanh_normalize(np.ones(3, np.float32)) is None
