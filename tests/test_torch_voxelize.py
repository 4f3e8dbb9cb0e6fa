"""The port's event voxelizers and encodings against frn_tpu's, on the CPU.

The device voxelizers (``voxelize_events``, ``voxelize_events_batched``,
``voxel_from_sparse``) are held against frn_tpu's device functions on every
edge case, and ``voxelize_events`` also against the host voxelizer
(``voxelize_events_np``) on in-bounds streams only: the device path takes t0
and t1 from the raw stream, the host path after dropping out-of-bounds
events, so the two differ where the first or last event is off the grid.
Each test names the function it holds against. The host encodings
(``event_representation_np``, ``sparse_cells_*``) are held against
frn_tpu's host functions. Tolerance: none. The grids are f32 sums of +-1 or
of int8 counts, exact in any order, and the binning is integer arithmetic.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from frn_tpu.ops import voxelize as jvox
from frn_tpu_torch.ops import voxelize as tvox

C, H, W = 5, 12, 16
N = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class Stream:
    x: np.ndarray  # int16, as the events wire ships them
    y: np.ndarray
    t: np.ndarray  # int32 window-relative us
    p: np.ndarray  # int8
    n: int  # valid prefix


def _stream(seed: int, n_valid: int = 64, lo: int = 0, hi: int = 1_000_000) -> Stream:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, W, N).astype(np.int16)
    y = rng.integers(0, H, N).astype(np.int16)
    t = np.sort(rng.integers(lo, hi, N)).astype(np.int32)
    p = rng.choice(np.array([-1, 1], np.int8), N)
    # padding past the valid prefix is zeros, as the dataset pads
    for a in (x, y, t, p):
        a[n_valid:] = 0
    return Stream(x, y, t, p, n_valid)


def _edge_cases():
    cases = {"in_bounds": _stream(0)}
    s = _stream(1)
    s.x[0] = W + 3  # the first event off the grid: t0 still comes from it
    cases["first_event_out_of_bounds"] = s
    s = _stream(2)
    s.y[s.n - 1] = H  # the last valid event off the grid: t1 still comes from it
    cases["last_event_out_of_bounds"] = s
    s = _stream(3)
    s.x[5], s.y[9], s.x[20], s.y[20] = -1, -4, -7, -2
    cases["negative_x_or_y"] = s
    s = _stream(4)
    s.n = 0
    cases["num_valid_0"] = s
    cases["num_valid_N"] = _stream(5, n_valid=N)
    s = _stream(6)
    s.t[: s.n] = 777  # span 0: every event in bin 0
    cases["span_0"] = s
    s = _stream(7)
    # span 1000 and C - 1 = 4: t_rel * 4 is a multiple of the span at
    # t = 250 k, where the reference's +1e-6 moves the event one bin down
    s.t[: s.n] = np.sort(np.concatenate([np.arange(0, 1001, 250), np.arange(0, 1000, 17)]))[: s.n]
    s.t[s.n - 1] = 1000
    cases["exact_bin_boundaries"] = s
    s = _stream(8, lo=5_000, hi=9_000)
    s.t[3], s.t[10] = 1_000, 4_999  # before t0: negative t_rel (floor, not truncation)
    cases["time_before_t0"] = s
    s = _stream(9)
    s.p[: s.n] = np.where(np.arange(s.n) % 3 == 0, 0, s.p[: s.n])  # p 0 counts -1
    cases["polarity_zero"] = s
    return cases


EDGE_CASES = _edge_cases()


def _jax_device(s: Stream) -> np.ndarray:
    # the JAX train step's casts (frn_tpu/train/loop.py)
    return np.asarray(jvox.voxelize_events(
        jnp.asarray(s.x.astype(np.int32)), jnp.asarray(s.y.astype(np.int32)), jnp.asarray(s.t),
        jnp.asarray(s.p.astype(np.int32)), jnp.int32(s.n), C, H, W))


def _port_device(s: Stream) -> torch.Tensor:
    return tvox.voxelize_events(torch.from_numpy(s.x), torch.from_numpy(s.y),
                                torch.from_numpy(s.t), torch.from_numpy(s.p), s.n, C, H, W)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_voxelize_events_equals_jax_device_voxelizer(case):
    """Against frn_tpu's device ``voxelize_events``, exactly."""
    s = EDGE_CASES[case]
    got = _port_device(s)
    assert got.dtype == torch.float32 and got.shape == (C, H, W)
    want = _jax_device(s)
    np.testing.assert_array_equal(got.numpy(), want)
    if case not in ("num_valid_0",):
        assert np.abs(want).sum() > 0


@pytest.mark.parametrize("case", ["in_bounds", "num_valid_N", "span_0", "exact_bin_boundaries",
                                  "polarity_zero"])
def test_voxelize_events_equals_host_voxelizer_in_bounds(case):
    """Against the host ``voxelize_events_np`` (frn_tpu's and the port's) on
    in-bounds sorted streams, exactly."""
    s = EDGE_CASES[case]
    v = slice(0, s.n)
    args = (s.x[v].astype(np.int64), s.y[v].astype(np.int64), s.t[v], s.p[v], C, H, W)
    want = jvox.voxelize_events_np(*args)
    np.testing.assert_array_equal(tvox.voxelize_events_np(*args), want)
    np.testing.assert_array_equal(_port_device(s).numpy(), want)


def test_voxelize_events_batched_equals_jax_device_voxelizer():
    """Every edge case as one row of a batch, against frn_tpu's device
    ``voxelize_events_batched`` (NHWC), exactly; each row also equals the
    port's single-stream ``voxelize_events``."""
    names = sorted(EDGE_CASES)
    rows = [EDGE_CASES[k] for k in names]
    x, y, t, p = (np.stack([getattr(s, f) for s in rows]) for f in "xytp")
    n = np.array([s.n for s in rows], np.int32)
    got = tvox.voxelize_events_batched(*(torch.from_numpy(a) for a in (x, y, t, p, n)), C, H, W)
    assert got.shape == (len(rows), H, W, C) and got.dtype == torch.float32
    want = np.asarray(jvox.voxelize_events_batched(
        jnp.asarray(x.astype(np.int32)), jnp.asarray(y.astype(np.int32)), jnp.asarray(t),
        jnp.asarray(p.astype(np.int32)), jnp.asarray(n), C, H, W))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, s in enumerate(rows):
        np.testing.assert_array_equal(got[i].numpy(), _port_device(s).permute(1, 2, 0).numpy(),
                                      err_msg=names[i])


def _sparse_voxel() -> tuple:
    """A grid past 65,535 cells with a gap of exactly 65,535, a gap longer
    than 65,535 (bridged), counts beyond +-127 (split) and a delta-0 neighbour."""
    vox = np.zeros((5, 64, 256), np.float32)  # 81,920 cells
    flat = vox.reshape(-1)
    flat[3] = 2
    flat[4] = 300  # |count| > 127: three cells
    flat[5] = -200
    flat[5 + 65535] = -1  # a gap of exactly 65,535
    flat[81_919] = 1
    vox2 = np.zeros((5, 96, 256), np.float32)  # 122,880 cells
    f2 = vox2.reshape(-1)
    f2[10], f2[10 + 110_000] = 1, -130  # a gap of 110,000: one bridge
    return vox, vox2


def _decode_both(deltas, counts, shape):
    c, h, w = shape
    got = tvox.voxel_from_sparse(torch.from_numpy(deltas), torch.from_numpy(counts), c, h, w)
    want = np.asarray(jvox.voxel_from_sparse(jnp.asarray(deltas), jnp.asarray(counts), c, h, w))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def test_voxel_from_sparse_equals_jax_device_decoder():
    """The port's decoder against frn_tpu's device ``voxel_from_sparse``,
    exactly, on encodings with a delta of 65,535, a bridge, split counts and
    padding; both give back the voxel."""
    for vox in _sparse_voxel():
        deltas, counts, n, dropped = jvox.sparse_cells_from_voxel_np(vox, capacity=64)
        assert dropped == 0 and n > 3 and deltas.max() == 65535
        assert (counts[:n] == 0).any() or np.abs(vox).max() > 127
        np.testing.assert_array_equal(_decode_both(deltas, counts, vox.shape), vox)


def test_voxel_from_sparse_sends_indices_past_the_grid_to_the_dump_slot():
    """Malformed deltas that run past the grid add nothing (frn_tpu's device
    decoder clips them into the dump slot too)."""
    shape = (2, 4, 8)  # 64 cells
    deltas = np.array([5, 10, 60, 65535, 3, 0], np.uint16)
    counts = np.array([1, -2, 3, 100, -5, 7], np.int8)
    want = np.zeros(64, np.float32)
    want[5], want[15] = 1, -2  # index 75 and past: dropped
    np.testing.assert_array_equal(_decode_both(deltas, counts, shape).reshape(-1), want)


@pytest.mark.parametrize("kind", ["voxel", "time_surface", "event_count", "binary"])
def test_event_representation_np_equals_jax(kind):
    """Against frn_tpu's host ``event_representation_np``, exactly; out-of-bounds
    events and an empty stream included."""
    rng = np.random.default_rng(11)
    n = 500
    x = rng.integers(0, W + 3, n)
    y = rng.integers(0, H + 2, n)
    t = np.sort(rng.integers(10_000_000, 10_050_000, n)).astype(np.int64)
    p = rng.integers(0, 2, n).astype(np.uint8)
    for sl in (slice(None), slice(0, 0), slice(0, 1)):
        args = (x[sl], y[sl], t[sl], p[sl], kind, C, H, W)
        got = tvox.event_representation_np(*args)
        want = jvox.event_representation_np(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_event_representation_np_rejects_unknown_kinds():
    x = np.array([1, 2])
    for fn in (tvox.event_representation_np, jvox.event_representation_np):
        with pytest.raises(ValueError, match="unknown event representation"):
            fn(x, x, x, x, "histogram", C, H, W)


def test_sparse_cells_equal_jax():
    """``sparse_cells_from_voxel_np`` and ``sparse_cells_np`` against frn_tpu's,
    exactly: the encodings above, an empty voxel, and a capacity that drops
    trailing cells."""
    for vox in _sparse_voxel() + (np.zeros((2, 3, 4), np.float32),):
        for cap in (64, 3):
            got = tvox.sparse_cells_from_voxel_np(vox, cap)
            want = jvox.sparse_cells_from_voxel_np(vox, cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert np.asarray(g).dtype == np.asarray(w).dtype
    s = EDGE_CASES["in_bounds"]
    args = (s.x[: s.n].astype(np.int64), s.y[: s.n].astype(np.int64), s.t[: s.n], s.p[: s.n],
            C, H, W, 40)
    for g, w in zip(tvox.sparse_cells_np(*args), jvox.sparse_cells_np(*args)):
        np.testing.assert_array_equal(g, w)
