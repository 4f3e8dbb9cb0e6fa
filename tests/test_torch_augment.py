"""The port's event-set augmentations against frn_tpu's, on the CPU.

Each transform and ``default_augmentations`` run with the same seeds on the
same seeded samples in both packages, so they draw the same flips, windows,
shifts and zooms. Events and boxes are held exactly, and so is the RGB image
of the flip, the crops and the translation. ``RandomZoom``'s RGB is held
against frn_tpu's OpenCV ``warpAffine`` at atol 1e-5 (the port warps in
numpy at the exact inverse coordinates; OpenCV interpolates in f32), in both
zoom directions; the zoom-out's bilinear event subsampling is held with the
native library in both packages and with the Python fallback in both.
"""

import numpy as np
import pytest

import frn_tpu.data.augment as jaug
from frn_tpu_torch.data import augment as taug

H, W = 48, 64
ZOOM_RGB_ATOL = 1e-5

pytestmark = pytest.mark.skipif(jaug.cv2 is None, reason="frn_tpu's RandomZoom warps with OpenCV")


def _sample(seed=0, n=4000, boxes=3):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, W - 12, boxes)
    y1 = rng.uniform(0, H - 12, boxes)
    annot = np.stack([x1, y1, x1 + rng.uniform(2, 12, boxes), y1 + rng.uniform(2, 12, boxes),
                      rng.integers(0, 3, boxes)], 1).astype(np.float32)
    return {"x": rng.integers(0, W, n).astype(np.int64),
            "y": rng.integers(0, H, n).astype(np.int64),
            "t": np.sort(rng.integers(0, 50_000, n)).astype(np.int64),
            "p": rng.integers(0, 2, n).astype(np.int8),
            "rgb": rng.random((H, W, 3)).astype(np.float32),
            "annot": annot}


def _assert_samples_equal(got, want, rgb_atol=0.0):
    assert sorted(got) == sorted(want)
    for key in ("x", "y", "t", "p", "annot"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["rgb"].dtype == want["rgb"].dtype and got["rgb"].shape == want["rgb"].shape
    if rgb_atol:
        np.testing.assert_allclose(got["rgb"], want["rgb"], atol=rgb_atol, rtol=0)
    else:
        np.testing.assert_array_equal(got["rgb"], want["rgb"])


TRANSFORMS = {
    "hflip": lambda m: m.RandomHFlip(W, p=0.5, seed=3),
    "crop": lambda m: m.Crop((5, 7), (50, 40)),
    "random_crop": lambda m: m.RandomCrop(H, W, 32, 40, seed=4),
    "translate": lambda m: m.RandomTranslate(H, W, max_shift=15, seed=5),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_exact_transforms_equal_jax(name):
    """Several samples in a row, so each random transform's generator is
    compared over several draws (the flip both taken and not)."""
    got_t, want_t = TRANSFORMS[name](taug), TRANSFORMS[name](jaug)
    for seed in range(6):
        sample = _sample(seed)
        _assert_samples_equal(got_t(dict(sample)), want_t(dict(sample)))


@pytest.mark.parametrize("zoom_range", [(0.8, 0.95), (1.05, 1.2)], ids=["out", "in"])
@pytest.mark.parametrize("subsample", ["native", "python"])
def test_random_zoom_equals_jax(monkeypatch, zoom_range, subsample):
    if subsample == "python":  # both packages on the literal fallback
        monkeypatch.setattr(taug, "native_event_subsample", lambda *a, **k: None)
        monkeypatch.setattr(jaug, "native_event_subsample", lambda *a, **k: None)
    else:
        assert taug.native_event_subsample(np.zeros((1, 2), np.float32),
                                           np.ones(1, np.float32), H, W) is not None
    got_t = taug.RandomZoom(H, W, zoom_range=zoom_range, seed=6)
    want_t = jaug.RandomZoom(H, W, zoom_range=zoom_range, seed=6)
    for seed in range(3):
        sample = _sample(seed, n=2000)
        got, want = got_t(dict(sample)), want_t(dict(sample))
        _assert_samples_equal(got, want, rgb_atol=ZOOM_RGB_ATOL)
        assert 0 < len(got["x"]) <= len(sample["x"])
        assert ((got["x"] >= 0) & (got["x"] < W) & (got["y"] >= 0) & (got["y"] < H)).all()
        assert not np.array_equal(got["rgb"], sample["rgb"])


def test_zoom_image_matches_opencv_on_uint8_and_gray():
    rng = np.random.default_rng(7)
    cv2 = jaug.cv2
    for img in (rng.integers(0, 256, (H, W, 3), dtype=np.uint8), rng.random((H, W)).astype(np.float32)):
        for z in (0.87, 1.13):
            cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
            want = cv2.warpAffine(img, cv2.getRotationMatrix2D((cx, cy), 0.0, z), (W, H))
            got = taug.zoom_image(img, z, cx, cy)
            assert got.dtype == img.dtype and got.shape == img.shape
            atol = 1 if img.dtype == np.uint8 else ZOOM_RGB_ATOL  # OpenCV rounds u8 in fixed point
            np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=atol,
                                       rtol=0)


@pytest.mark.parametrize("subsample", ["native", "python"])
def test_bilinear_event_subsample_equals_jax(monkeypatch, subsample):
    rng = np.random.default_rng(8)
    pos = np.stack([rng.uniform(0, W - 1, 3000), rng.uniform(0, H - 1, 3000)], 1).astype(np.float32)
    pol = rng.choice([-1.0, 1.0], 3000).astype(np.float32)
    if subsample == "python":
        monkeypatch.setattr(taug, "native_event_subsample", lambda *a, **k: None)
    got_pos, got_mask = taug.bilinear_event_subsample(pos, pol, H, W)
    want_pos, want_mask = jaug._subsample_python(pos, pol, H, W)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got_pos[got_mask], want_pos[want_mask])
    assert 0 < got_mask.sum() < len(pos)


def test_default_augmentations_equal_jax():
    got_t, want_t = taug.default_augmentations(H, W, seed=9), jaug.default_augmentations(H, W, seed=9)
    assert [type(t).__name__ for t in got_t.transforms] == [type(t).__name__ for t in want_t.transforms]
    for seed in range(5):
        sample = _sample(seed + 10)
        _assert_samples_equal(got_t(dict(sample)), want_t(dict(sample)), rgb_atol=ZOOM_RGB_ATOL)


def test_a_sample_without_rgb_or_boxes():
    sample = _sample(1)
    sample["rgb"], sample["annot"] = None, np.zeros((0, 5), np.float32)
    for seed in range(3):
        got = taug.default_augmentations(H, W, seed=seed)(dict(sample))
        want = jaug.default_augmentations(H, W, seed=seed)(dict(sample))
        assert got["rgb"] is None and want["rgb"] is None
        for key in ("x", "y", "t", "p", "annot"):
            np.testing.assert_array_equal(got[key], want[key])
