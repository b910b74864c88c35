"""The port's native loader (tpuimg_torch/csrc/loader.cpp through
tpuimg_torch.native): tests/test_native.py's cases but the one that needs a
reference image, and PNGs crossing between the port's codec, tpuimg's and
cv2, bit for bit. Each test skips when the loader cannot build here (g++,
libpng16, libjpeg)."""

import numpy as np
import pytest

from tpuimg_torch import native


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("native loader does not build here")
    return native


@pytest.fixture
def jax_native():
    from tpuimg import native as jn

    if not jn.available():
        pytest.skip("tpuimg's native library unavailable")
    return jn


def test_builds_into_the_port_build_dir(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "tpuimg_torch"


def test_png_roundtrip(lib, rng, tmp_path):
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    np.testing.assert_array_equal(native.read_image(p, gray=True), img)


def test_rgb_roundtrip(lib, rng, tmp_path):
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    np.testing.assert_array_equal(native.read_image(p, gray=False), img)


@pytest.mark.parametrize("shape", [(33, 47), (20, 31, 3)])
def test_png_crosses_tpuimg_and_cv2(lib, jax_native, rng, tmp_path, shape):
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    gray = img.ndim == 2
    ours = str(tmp_path / "ours.png")
    native.write_png(ours, img)
    np.testing.assert_array_equal(jax_native.read_image(ours, gray=gray), img)
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    by_cv2 = cv2.imread(ours, flag)
    np.testing.assert_array_equal(by_cv2 if gray else by_cv2[..., ::-1], img)
    theirs = str(tmp_path / "theirs.png")
    jax_native.write_png(theirs, img)
    np.testing.assert_array_equal(native.read_image(theirs, gray=gray), img)
    cv2_png = str(tmp_path / "cv2.png")
    assert cv2.imwrite(cv2_png, img if gray else img[..., ::-1])
    np.testing.assert_array_equal(native.read_image(cv2_png, gray=gray), img)
    # the two loaders write the same file
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_stream_delivers_all_frames(lib, rng, tmp_path):
    imgs = [rng.integers(0, 256, (32, 48), dtype=np.uint8) for _ in range(5)]
    paths = []
    for i, im in enumerate(imgs):
        p = str(tmp_path / f"f{i}.png")
        native.write_png(p, im)
        paths.append(p)
    seen = {}
    with native.FrameStream(paths, (32, 48), gray=True, threads=3,
                            capacity=2) as fs:
        for idx, frame in fs:
            seen[idx] = frame.copy()
    assert sorted(seen) == list(range(5))
    for i, im in enumerate(imgs):
        np.testing.assert_array_equal(seen[i], im)


def test_stream_rgb_frames(lib, rng, tmp_path):
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    native.write_png(p, img)
    with native.FrameStream([p, p], (16, 24), gray=False, threads=2) as fs:
        frames = list(fs)
    assert sorted(i for i, _ in frames) == [0, 1]
    for _, f in frames:
        np.testing.assert_array_equal(f, img)


def test_stream_resizes_to_slot(lib, rng, tmp_path):
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    with native.FrameStream([p], (32, 48), gray=True) as fs:
        frames = list(fs)
    assert frames[0][1].shape == (32, 48)


def test_stream_stops_after_close(lib, rng, tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.png")
        native.write_png(p, rng.integers(0, 256, (8, 8), dtype=np.uint8))
        paths.append(p)
    fs = native.FrameStream(paths, (8, 8), gray=True, threads=2)
    it = iter(fs)
    next(it)
    fs.close()
    assert list(it) == []
    fs.close()  # idempotent


def test_stream_raises_on_corrupt_frame(lib, rng, tmp_path):
    good = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    gp = str(tmp_path / "good.png")
    native.write_png(gp, good)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89Pnot-really-a-png")
    with pytest.raises(IOError, match="failed to decode frame 1"):
        with native.FrameStream([gp, bad], (16, 24), gray=True,
                                threads=1) as fs:
            list(fs)


def test_read_image_raises_on_missing_file(lib, tmp_path):
    with pytest.raises(IOError, match="failed to decode"):
        native.read_image(str(tmp_path / "none.png"))


def test_write_png_rejects_unsupported_channels(lib, tmp_path):
    rgba = np.zeros((8, 8, 4), np.uint8)
    with pytest.raises(ValueError):
        native.write_png(str(tmp_path / "x.png"), rgba)


def test_write_png_rejects_non_uint8(lib, tmp_path):
    with pytest.raises(TypeError, match="uint8"):
        native.write_png(str(tmp_path / "x.png"), np.zeros((8, 8), np.float32))
