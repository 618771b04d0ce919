"""The port's JPEG decoder (csrc/jpeg_decode.c through data/image_io.py)
against cv2.imread, bit for bit, on JPEGs that cv2.imencode writes here:
qualities 50-100, 4:2:0 / 4:2:2 / 4:4:4 (and 4:4:0, 4:1:1) sampling,
optimised Huffman tables, restart intervals, gray sources, odd sizes where
the MCU padding and the upsampler's edges show, a 480x640 frame; the
refusals; the committed card fixture; and the train loader on a BOP scene
whose rgb/ holds JPEGs against the JAX loader (which reads them with
cv2.imread)."""

import itertools
import os

import cv2
import numpy as np
import pytest

from self6dpp_tpu_torch.data import image_io as tio

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..",
                           "self6dpp_tpu_torch", "fixtures", "jpeg")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
EXTRA = {"plain": [], "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
         "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


def scene_image(h, w, seed=0, channels=3, noise=12.0):
    """A smooth random field with sharp-edged boxes and pixel noise (uint8,
    BGR as cv2 writes it): chroma edges for the upsampler, texture for the
    AC coefficients."""
    rng = np.random.default_rng(seed)
    x = rng.random((h // 4 + 2, w // 4 + 2, channels)) * 255
    img = cv2.resize(x, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.reshape(h, w, channels)
    for _ in range(4):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + h // 3 + 1, x0:x0 + w // 3 + 1] = rng.random(channels) * 255
    img = img + rng.normal(0, noise, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def encode(img, quality=95, sampling="420", extra="plain"):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params + EXTRA[extra])
    assert ok
    return buf


def assert_decodes_as_cv2(buf):
    data = buf.tobytes()
    ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    got = tio.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), np.abs(got.astype(int) - ref).max()
    ref_g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    assert np.array_equal(tio.decode_jpeg(data, gray=True), ref_g)


@pytest.mark.parametrize("quality,sampling,extra", list(itertools.product(
    (50, 75, 95, 100), ("420", "422", "444"), tuple(EXTRA))))
def test_decode_matches_cv2_61x77(quality, sampling, extra):
    assert_decodes_as_cv2(encode(scene_image(61, 77, seed=quality),
                                 quality, sampling, extra))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (8, 8), (15, 16), (16, 15),
                                 (17, 33), (3, 70), (70, 3)])
@pytest.mark.parametrize("sampling", ["420", "422", "444", "440", "411"])
def test_decode_matches_cv2_odd_sizes(h, w, sampling):
    """Sizes where a component is 1-3 samples wide (the box upsampler),
    partial MCUs at both edges, and the rarer factors."""
    assert_decodes_as_cv2(encode(scene_image(h, w, seed=h * 100 + w), 90,
                                 sampling, "restart" if h > w else "plain"))


@pytest.mark.parametrize("sampling", ["420", "422"])
def test_decode_matches_cv2_frame(sampling):
    assert_decodes_as_cv2(encode(scene_image(480, 640, seed=7), 95, sampling,
                                 "optimized"))


@pytest.mark.parametrize("h,w", [(61, 77), (480, 640)])
def test_decode_matches_cv2_gray_source(h, w):
    """One-component files: 'color' repeats Y, as cv2.IMREAD_COLOR does."""
    assert_decodes_as_cv2(encode(scene_image(h, w, seed=3, channels=1), 80))


def test_imread_picks_the_format_by_its_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg; imread's three modes."""
    img = scene_image(30, 41, seed=1)
    jpg_as_png = str(tmp_path / "a.png")
    encode(img, 85).tofile(jpg_as_png)
    png_as_jpg = str(tmp_path / "b.jpg")
    assert cv2.imwrite(str(tmp_path / "b.png"), img)
    os.rename(str(tmp_path / "b.png"), png_as_jpg)
    ref = cv2.imread(jpg_as_png, cv2.IMREAD_COLOR)[..., ::-1]
    assert np.array_equal(tio.imread(jpg_as_png, "color"), ref)
    assert np.array_equal(tio.imread(jpg_as_png, "unchanged"), ref)
    assert np.array_equal(tio.imread(jpg_as_png, "gray"),
                          cv2.imread(jpg_as_png, cv2.IMREAD_GRAYSCALE))
    assert np.array_equal(tio.imread(png_as_jpg, "color"), img[..., ::-1])
    gray = str(tmp_path / "g.jpg")
    encode(scene_image(30, 41, seed=2, channels=1), 85).tofile(gray)
    assert np.array_equal(tio.imread(gray, "unchanged"),
                          cv2.imread(gray, cv2.IMREAD_UNCHANGED))


def _exif_orientation_segment(orientation):
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    tiff = (b"MM\x00\x2a\x00\x00\x00\x08" + b"\x00\x01"
            + b"\x01\x12\x00\x03\x00\x00\x00\x01"
            + orientation.to_bytes(2, "big") + b"\x00\x00"
            + b"\x00\x00\x00\x00")
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body


def test_decoder_refuses_what_it_does_not_decode(tmp_path):
    img = scene_image(24, 32, seed=4)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    base = encode(img, 90).tobytes()
    sof = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[sof + 4] = 12                          # sample precision
    arith = bytearray(base)
    arith[sof + 1] = 0xC9                         # SOF9
    cmyk = bytearray(base)
    cmyk[sof + 9] = 4                             # component count
    rotated = base[:2] + _exif_orientation_segment(6) + base[2:]
    upright = base[:2] + _exif_orientation_segment(1) + base[2:]
    cases = {"progressive": prog.tobytes(), "12-bit": bytes(twelve),
             "arithmetic": bytes(arith), "CMYK": bytes(cmyk),
             "orientation 6": rotated}
    for what, data in cases.items():
        path = str(tmp_path / f"{what.split()[0]}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=what) as e:
            tio.imread(path, "color")
        assert path in str(e.value)
    assert np.array_equal(tio.decode_jpeg(upright), tio.decode_jpeg(base))
    with pytest.raises(ValueError, match="not a JPEG"):
        tio.decode_jpeg(b"\x89PNG\r\n\x1a\n....")


# ------------------------------------------------------------ card fixture
# chip_smoke.py decodes these on the card machine (which has no cv2) and
# holds them bit for bit against cv2's decode stored beside them.
FIXTURES = {
    "frame_420_q95": dict(h=480, w=640, seed=11, quality=95, sampling="420",
                          extra="plain"),
    "odd_422_rst": dict(h=237, w=317, seed=12, quality=90, sampling="422",
                        extra="restart"),
}


def fixture_image(h, w, seed):
    """Flat boxes on a flat ground and a smooth random field in the top
    left corner: flat areas keep cv2's decode small in a .npz, the edges and
    the field carry the AC coefficients and the chroma upsampling."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3))
    img[:] = rng.random(3) * 255
    for _ in range(24):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        img[y0:y0 + rng.integers(4, h // 3),
            x0:x0 + rng.integers(4, w // 3)] = rng.random(3) * 255
    sh, sw = int(h * 0.3), int(w * 0.3)
    field = rng.random((sh // 8 + 2, sw // 8 + 2, 3)) * 255
    img[:sh, :sw] = cv2.resize(field, (sw, sh), interpolation=cv2.INTER_CUBIC)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_fixture(name):
    """(jpeg bytes, cv2's RGB decode, cv2's gray decode) of a fixture."""
    f = FIXTURES[name]
    img = fixture_image(f["h"], f["w"], f["seed"])
    buf = encode(img, f["quality"], f["sampling"], f["extra"])
    return (buf.tobytes(), cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1],
            cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def write_fixtures(directory=FIXTURE_DIR):
    """Regenerate the committed fixture: one .jpg per entry and
    decoded.npz with each one's 'rgb' and 'gray' decode."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    for name in FIXTURES:
        data, rgb, gray = make_fixture(name)
        with open(os.path.join(directory, f"{name}.jpg"), "wb") as f:
            f.write(data)
        arrays[f"{name}_rgb"], arrays[f"{name}_gray"] = rgb, gray
    np.savez_compressed(os.path.join(directory, "decoded.npz"), **arrays)


def test_committed_fixture_is_cv2s():
    """The committed card fixture is what this generator and cv2 give, and
    the port decodes it bit for bit; it stays small."""
    ref = np.load(os.path.join(FIXTURE_DIR, "decoded.npz"))
    total = os.path.getsize(os.path.join(FIXTURE_DIR, "decoded.npz"))
    for name in FIXTURES:
        path = os.path.join(FIXTURE_DIR, f"{name}.jpg")
        data, rgb, gray = make_fixture(name)
        with open(path, "rb") as f:
            assert f.read() == data, name
        assert np.array_equal(ref[f"{name}_rgb"], rgb)
        assert np.array_equal(ref[f"{name}_gray"], gray)
        assert np.array_equal(tio.imread(path, "color"), rgb)
        assert np.array_equal(tio.imread(path, "gray"), gray)
        total += os.path.getsize(path)
    assert total < 400_000, total


# ----------------------------------------------------------- the loader
def test_train_loader_on_jpeg_scene_matches_jax(tmp_path, monkeypatch):
    """A BOP scene whose rgb/ holds JPEGs (as the *_pbr sets do): the
    port's load_bop_split and train loader against the JAX package's,
    roi_img bit for bit."""
    from tools.make_synthetic_bop import generate

    import test_torch_loader as tl
    from self6dpp_tpu.data.meshes import make_cube, make_icosphere

    split = generate(str(tmp_path / "bop"), n_scenes=1, n_images=3)
    rgb_dir = os.path.join(split, "000000", "rgb")
    for name in sorted(os.listdir(rgb_dir)):
        png = os.path.join(rgb_dir, name)
        img = cv2.imread(png, cv2.IMREAD_COLOR)
        encode(img, 93, "420").tofile(png[:-4] + ".jpg")
        os.unlink(png)
    v1, f1 = make_cube(size=0.12)
    v2, f2 = make_icosphere(radius=0.07, subdivisions=2)
    meshes = [{"verts": v1, "faces": f1}, {"verts": v2, "faces": f2}]
    cfgs = tl.configs(color_aug_prob=0.0)
    jb, tb, _ = tl.run_both(split, meshes, monkeypatch, cfgs, batch_size=3,
                            train=True, n_batches=2, num_workers=0)
    assert all(r.file_name.endswith(".jpg")
               for r in tl.tbop.load_bop_split(split))
    tl.assert_batches_equal(jb, tb)
    for a, b in zip(jb, tb):
        assert np.array_equal(a["roi_img"], b["roi_img"])
