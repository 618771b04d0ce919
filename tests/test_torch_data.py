"""The port's data layer against the JAX package's and OpenCV on the CPU:
the PNG codec (bitwise against cv2 both ways), PLY reading and writing,
BOP records and detections, the cv2.warpAffine crop (nearest bitwise,
linear within 1e-5 of cv2 and of the JAX crop), ObjectModels, FPS regions,
the synthetic BOP generator and the config registry."""

import dataclasses
import importlib.util
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from self6dpp_tpu.config import base as jcfg
from self6dpp_tpu.data import aug as jaug
from self6dpp_tpu.data import bop as jbop
from self6dpp_tpu.data import loader as jloader
from self6dpp_tpu.data import meshes as jmeshes
from self6dpp_tpu.ops import fps as jfps
from self6dpp_tpu_torch import config as tcfg
from self6dpp_tpu_torch.data import aug as taug
from self6dpp_tpu_torch.data import bop as tbop
from self6dpp_tpu_torch.data import image_io as tio
from self6dpp_tpu_torch.data import loader as tloader
from self6dpp_tpu_torch.data import meshes as tmeshes
from self6dpp_tpu_torch.data import ref as tref
from self6dpp_tpu_torch.ops import fps as tfps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def numpy_fps(monkeypatch):
    """The JAX FPS may call its native library, which breaks ties otherwise
    than its numpy path; the port has the numpy path."""
    monkeypatch.setattr(jfps, "_lib", False)


@pytest.fixture(scope="module")
def jax_bop(tmp_path_factory):
    from tools.make_synthetic_bop import generate
    return generate(str(tmp_path_factory.mktemp("jbop")), n_scenes=1,
                    n_images=3)


# --------------------------------------------------------------------- PNG
@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8), ((37, 53, 3), np.uint8), ((29, 41), np.uint16),
    ((120, 160, 3), np.uint8)])
def test_png_bitwise_against_cv2_both_ways(tmp_path, shape, dtype):
    rng = np.random.default_rng(0)
    top = 255 if dtype == np.uint8 else 65535
    img = (rng.random(shape) * top).astype(dtype)
    img[: shape[0] // 3] = 7                 # flat rows: other filter choices
    bgr = img[..., ::-1] if img.ndim == 3 else img
    for level in (1, 9):
        p = str(tmp_path / f"cv{level}.png")
        cv2.imwrite(p, bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
        got = tio.imread(p, "color" if img.ndim == 3 else "unchanged")
        assert got.dtype == img.dtype and np.array_equal(got, img)
    p = str(tmp_path / "port.png")
    tio.write_png(p, img)
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    back = back[..., ::-1] if back.ndim == 3 else back
    assert back.dtype == img.dtype and np.array_equal(back, img)
    if img.ndim == 2 and dtype == np.uint8:
        assert np.array_equal(tio.imread(p, "gray"),
                              cv2.imread(p, cv2.IMREAD_GRAYSCALE))
        assert np.array_equal(tio.imread(p, "color"),
                              cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1])


def _row_filters(path):
    """The filter type of every row of a non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = w * {0: 1, 2: 3}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, stride + 1)[:, 0]


@pytest.mark.parametrize("filter_type", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["gray", "rgb", "depth"])
def test_png_every_filter_type_against_cv2(tmp_path, kind, filter_type):
    """Each filter type written on every row, and libpng's adaptive choice
    (a mix, Average and Paeth among it, on a smooth noisy image as camera
    frames are), read back bit for bit by cv2 and by the port."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:48, :64].astype(np.float64)
    base = np.stack([xx * 2 + yy, 120 + xx - yy, yy * 3], axis=-1)
    img = {"gray": lambda: base[..., 0], "rgb": lambda: base,
           "depth": lambda: 600 + 40 * base[..., 0]}[kind]()
    img = img + rng.normal(0, 3 if kind != "depth" else 60, img.shape)
    top = 65535 if kind == "depth" else 255
    img = np.clip(img, 0, top).astype(np.uint16 if kind == "depth"
                                      else np.uint8)
    p = str(tmp_path / "f.png")
    tio.write_png(p, img, filter_type=filter_type)
    rows = _row_filters(p)
    if filter_type is None:
        assert {3, 4} & set(rows.tolist()) and len(set(rows.tolist())) > 1
    else:
        assert (rows == filter_type).all()
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    back = back[..., ::-1] if back.ndim == 3 else back
    assert back.dtype == img.dtype and np.array_equal(back, img)
    assert np.array_equal(tio.imread(p), img)


def test_png_raises_on_an_unknown_filter_type(tmp_path):
    p = str(tmp_path / "f5.png")
    _png(p, struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0),
         b"\x00\x01\x02\x05\x03\x04")
    with pytest.raises(ValueError, match="f5.png.*filter type 5"):
        tio.imread(p)
    with pytest.raises(ValueError, match="filter type"):
        tio.write_png(p, np.zeros((2, 2), np.uint8), filter_type=5)


def test_png_rgba_reads_rgb(tmp_path):
    rgba = np.random.default_rng(1).integers(0, 256, (9, 11, 4), np.uint8)
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, rgba[..., [2, 1, 0, 3]])
    assert np.array_equal(tio.imread(p, "color"), rgba[..., :3])


def _png(path, ihdr, idat=b"", extra=()):
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b
                          + struct.pack(">I", zlib.crc32(k + b)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + b"".join(chunk(k, b) for k, b in extra)
                + chunk(b"IDAT", zlib.compress(idat)) + chunk(b"IEND", b""))


def test_png_raises_on_what_it_does_not_read(tmp_path):
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    gif = str(tmp_path / "a.gif")
    with open(gif, "wb") as f:
        f.write(b"GIF89a" + b"\0" * 20)
    inter = str(tmp_path / "inter.png")
    _png(inter, struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1), b"\0" * 40)
    pal = str(tmp_path / "pal.png")
    _png(pal, struct.pack(">IIBBBBB", 2, 1, 8, 3, 0, 0, 0), b"\0\0\0",
         extra=[(b"PLTE", b"\0\0\0")])
    rgb16 = str(tmp_path / "rgb16.png")
    cv2.imwrite(rgb16, np.zeros((4, 4, 3), np.uint16))
    bad_crc = str(tmp_path / "crc.png")
    _png(bad_crc, struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 0), b"\0\0")
    data = bytearray(open(bad_crc, "rb").read())
    data[29] ^= 1                                  # inside IHDR's CRC
    open(bad_crc, "wb").write(bytes(data))
    for path, what in ((jpg, "progressive"), (gif, "not a PNG"),
                       (inter, "interlaced"),
                       (pal, "palette"), (rgb16, "16-bit"),
                       (bad_crc, "CRC")):
        with pytest.raises(ValueError, match=what) as e:
            tio.imread(path)
        assert path in str(e.value)


# --------------------------------------------------------------------- PLY
def _binary_ply(path, quad=False):
    """A little-endian binary PLY with normals, colours, uv and a texture
    file (a BOP textured model's layout); with quad, its last face has 4
    ids. Returns what load_ply should read."""
    v = np.array([[0, 0, 0], [10, 0, 0], [0, 20, 0], [0, 0, 30]], np.float32)
    n = np.eye(4, 3, dtype=np.float32)
    c = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9]], np.uint8)
    uv = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0.5]], np.float32)
    faces = [[0, 1, 2], [0, 2, 3], [1, 3, 2, 0] if quad else [1, 3, 2]]
    head = ("ply\nformat binary_little_endian 1.0\n"
            "comment TextureFile tex.png\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "property float texture_u\nproperty float texture_v\n"
            "element face 3\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    body = b"".join(struct.pack("<6f3B2f", *v[i], *n[i], *c[i], *uv[i])
                    for i in range(4))
    body += b"".join(struct.pack(f"<B{len(f)}i", len(f), *f) for f in faces)
    with open(path, "wb") as fh:
        fh.write(head + body)
    return {"verts": v, "normals": n, "colors": (c / 255.0).astype(np.float32),
            "uv": uv, "faces": np.array([f[:3] for f in faces], np.int32),
            "texture_file": "tex.png"}


def _same_dict(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_ply_matches_jax(tmp_path):
    v, f = tmeshes.make_icosphere(0.07, 1)
    colors = np.random.default_rng(2).random(v.shape).astype(np.float32)
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmeshes.save_ply(pj, v * 1000, f, colors)
    tmeshes.save_ply(pt, v * 1000, f, colors)
    assert open(pj).read() == open(pt).read()
    _same_dict(jmeshes.load_ply(pj), tmeshes.load_ply(pj))
    # binary: the JAX loader takes the face list's name for its index type
    # and fails on binary faces, so the file's own values are the reference
    for quad in (False, True):
        pb = str(tmp_path / f"b{quad}.ply")
        want = _binary_ply(pb, quad)
        m = tmeshes.load_ply(pb)
        _same_dict(want, m)
    pv, pf = tmeshes.pad_mesh(m["verts"], m["faces"], 6, 5)
    jv, jf = jmeshes.pad_mesh(m["verts"], m["faces"], 6, 5)
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf)


# ----------------------------------------------------- records, detections
def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in dataclasses.fields(ra):
            x, y = getattr(ra, f.name), getattr(rb, f.name)
            if f.name == "instances":
                assert len(x) == len(y)
                for ia, ib in zip(x, y):
                    for g in dataclasses.fields(ia):
                        u, w = getattr(ia, g.name), getattr(ib, g.name)
                        if isinstance(u, np.ndarray):
                            assert u.dtype == w.dtype and np.array_equal(u, w)
                        else:
                            assert u == w, g.name
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert x == y, f.name


def test_records_and_detections_match_jax(jax_bop, tmp_path):
    jr = jbop.load_bop_split(jax_bop)
    tr = tbop.load_bop_split(jax_bop)
    _same_records(jr, tr)
    _same_records(jbop.load_bop_split(jax_bop, obj_ids={2}, visib_thresh=0.5),
                  tbop.load_bop_split(jax_bop, obj_ids={2}, visib_thresh=0.5))
    rng = np.random.default_rng(3)
    dets = {r.scene_im_id: [
        {"obj_id": i.obj_id, "score": float(rng.random()),
         "bbox_est": [float(x) for x in rng.uniform(10, 50, 4)],
         "pose_est": rng.random(12).tolist(),
         "pose_refine": rng.random(12).tolist()}
        for i in r.instances for _ in range(2)] for r in jr[:2]}
    dets["0/99"] = [{"obj_id": 1, "bbox_est": [1, 2, 3, 4]}]
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jbop.save_detections(pj, dets)
    tbop.save_detections(pt, dets)
    assert json.load(open(pj)) == json.load(open(pt)) == tbop.load_detections(pj)
    for kw in ({}, {"top_k_per_obj": 2, "score_thresh": 0.3},
               {"train_with_pseudo": True}):
        _same_records(jbop.inject_detections(jr, dets, **kw),
                      tbop.inject_detections(tr, dets, **kw))


def test_meta_and_symmetries_match_jax():
    from self6dpp_tpu.data import ref as jref
    for name in ("lm_full", "lm", "lmo", "ycbv", "synthetic", "hb", "lm_13_test"):
        a, b = jref.get_meta(name), tref.get_meta(name)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
    info = {"symmetries_discrete": [np.diag([-1, -1, 1, 1]).ravel().tolist()],
            "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}
    for a, b in zip(jref.sym_rotations_from_info(info, 8),
                    tref.sym_rotations_from_info(info, 8)):
        assert np.array_equal(a, b)
    with pytest.raises(KeyError):
        tref.get_meta("nope")


# --------------------------------------------------------------------- crops
@pytest.mark.parametrize("cn", [1, 2, 3, 6])
def test_crop_matches_cv2_and_jax(cn):
    rng = np.random.default_rng(cn)
    img = rng.random((120, 160, cn)).astype(np.float32)
    img = img[..., 0] if cn == 1 else img
    for _ in range(12):
        center = rng.uniform(-20, 180, 2)
        scale = float(rng.uniform(5, 300))
        out = int(rng.choice([16, 64, 256]))
        M = taug.get_affine_transform(center, scale, out)
        assert np.array_equal(M, jaug.get_affine_transform(center, scale, out))
        for interp, flag in (("nearest", cv2.INTER_NEAREST),
                             ("linear", cv2.INTER_LINEAR)):
            got = taug.crop_resize_by_warp_affine(img, center, scale, out,
                                                  interp)
            ref = cv2.warpAffine(img, M, (out, out), flags=flag)
            jax_crop = jaug.crop_resize_by_warp_affine(img, center, scale,
                                                       out, interp)
            assert got.shape == ref.shape and got.dtype == np.float32
            if interp == "nearest":
                assert np.array_equal(got, ref) and np.array_equal(got, jax_crop)
            else:
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
                np.testing.assert_allclose(got, jax_crop, rtol=0, atol=1e-5)
        # the label cache's destination-to-source map (WARP_INVERSE_MAP)
        Mi = np.array([[rng.uniform(0.3, 3), 0, rng.uniform(-40, 40)],
                       [0, rng.uniform(0.3, 3), rng.uniform(-40, 40)]])
        ref = cv2.warpAffine(img, Mi, (out, out),
                             flags=cv2.INTER_NEAREST | cv2.WARP_INVERSE_MAP)
        assert np.array_equal(
            taug.warp_affine(img, Mi, (out, out), "nearest", True), ref)
    # a rotation: no crop of the pipeline has one, and the port takes none
    with pytest.raises(ValueError, match="axis-aligned"):
        taug.warp_affine(img, cv2.getRotationMatrix2D((70.0, 50.0), 33.0, 1.3),
                         (90, 70))


def test_dzi_and_coord_match_jax():
    bbox = np.array([20.0, 30.0, 90.0, 70.0], np.float32)
    for t in ("uniform", "roi10d", "none"):
        a = jaug.aug_bbox_dzi(jcfg.DZIConfig(type=t), bbox, 120, 160,
                              np.random.default_rng(5))
        b = taug.aug_bbox_dzi(tcfg.DZIConfig(type=t), bbox, 120, 160,
                              np.random.default_rng(5))
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert np.array_equal(jaug.get_2d_coord(37, 23), taug.get_2d_coord(37, 23))


# ------------------------------------------------------------ object models
def test_object_models_match_jax(tmp_path):
    v1, f1 = tmeshes.make_cube(size=0.12)
    v2, f2 = tmeshes.make_icosphere(radius=0.07, subdivisions=2)
    meshes = [{"verts": v1, "faces": f1}, {"verts": v2, "faces": f2}]
    kw = dict(n_regions=8, n_points=64, max_sym=4, sym_names=("can",))
    a = jloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    b = tloader.ObjectModels.from_meshes(["ape", "can"], meshes, **kw)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "normals":
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-5)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y
    # PLY files with a PNG texture beside them (read, never skipped)
    paths = []
    for i, (v, f) in enumerate([(v1, f1), (v2, f2)]):
        p = str(tmp_path / f"obj_{i}.ply")
        tmeshes.save_ply(p, v * 1000, f)
        paths.append(p)
    with open(str(tmp_path / "tex_obj.ply"), "w") as fh:
        fh.write("ply\nformat ascii 1.0\ncomment TextureFile tex.png\n"
                 "element vertex 4\nproperty float x\nproperty float y\n"
                 "property float z\nproperty float texture_u\n"
                 "property float texture_v\nelement face 2\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0 0 0\n10 0 0 1 0\n0 20 0 0 1\n0 0 30 0.5 0.5\n"
                 "3 0 1 2\n3 0 2 3\n")
    tex = np.random.default_rng(6).integers(0, 256, (5, 7, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "tex.png"), tex[..., ::-1])
    paths.append(str(tmp_path / "tex_obj.ply"))
    names = ["a", "b", "c"]
    a = jloader.ObjectModels.from_ply_files(names, paths, **kw)
    b = tloader.ObjectModels.from_ply_files(names, paths, **kw)
    for f in ("verts", "faces", "colors", "fps_points", "pm_points",
              "extents", "diameters", "uvs", "textures"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(b.normals, a.normals, rtol=0, atol=1e-5)
    os.remove(str(tmp_path / "tex.png"))
    with pytest.raises(FileNotFoundError):
        tloader.ObjectModels.from_ply_files(names, paths, **kw)


def test_fps_and_regions_match_jax():
    rng = np.random.default_rng(7)
    pts = rng.random((300, 3)).astype(np.float32)
    assert np.array_equal(tfps.farthest_point_sampling(pts, 16),
                          jfps.farthest_point_sampling(pts, 16))
    xyz = rng.random((3, 9, 11, 3)).astype(np.float32)
    centres = rng.random((3, 8, 3)).astype(np.float32)
    mask = rng.random((3, 9, 11)) > 0.3
    assert np.array_equal(tfps.xyz_to_region_batch(xyz, centres, mask),
                          jfps.xyz_to_region_batch(xyz, centres, mask))
    assert np.array_equal(tfps.xyz_to_region(xyz[0], centres[0], mask[0]),
                          jfps.xyz_to_region(xyz[0], centres[0], mask[0]))


# ---------------------------------------------------------------- generator
def test_generate_matches_jax(jax_bop, tmp_path):
    """The port's synthetic set against the JAX tool's files: JSON and masks
    equal, RGB and depth within 1 unit (the two rasterizers' float rounding
    before the cast)."""
    from self6dpp_tpu_torch.data.synthetic_bop import generate
    split = generate(str(tmp_path), n_scenes=1, n_images=3, device="cpu",
                     impl="plain")
    a, b = os.path.join(jax_bop, "000000"), os.path.join(split, "000000")
    for name in ("scene_gt.json", "scene_camera.json", "scene_gt_info.json"):
        assert json.load(open(os.path.join(a, name))) == \
            json.load(open(os.path.join(b, name)))
    for sub in ("rgb", "depth", "mask", "mask_visib"):
        files = sorted(os.listdir(os.path.join(a, sub)))
        assert files == sorted(os.listdir(os.path.join(b, sub)))
        for f in files:
            x = cv2.imread(os.path.join(a, sub, f), cv2.IMREAD_UNCHANGED)
            x = x[..., ::-1] if x.ndim == 3 else x
            y = tio.imread(os.path.join(b, sub, f))
            assert x.dtype == y.dtype and x.shape == y.shape
            d = np.abs(x.astype(np.int64) - y).max()
            assert d == 0 if sub.startswith("mask") else d <= 1, (sub, f, d)


# ------------------------------------------------------------------ configs
def _jax_config(rel):
    spec = importlib.util.spec_from_file_location(
        "_cfg_" + rel.replace("/", "_")[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()


def _held_to(port, ref, where=""):
    """Every field of the port's config equals the JAX one's; every JAX
    field the port lacks is at its JAX default (nothing set is dropped)."""
    names = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        x = getattr(ref, f.name)
        if f.name not in names:
            default = f.default if f.default is not dataclasses.MISSING \
                else f.default_factory()
            assert x == default, f"{where}{f.name}: {x!r} set, port lacks it"
        elif dataclasses.is_dataclass(x):
            _held_to(getattr(port, f.name), x, f"{where}{f.name}.")
        else:
            assert getattr(port, f.name) == x, f"{where}{f.name}"
    assert names <= {f.name for f in dataclasses.fields(ref)}, where


@pytest.mark.parametrize("rel", sorted(tcfg.CONFIGS))
def test_config_registry_matches_jax(rel):
    _held_to(tcfg.load_config(rel), _jax_config(rel))
    assert tcfg.load_config("./" + rel) == tcfg.load_config(
        os.path.join(ROOT, rel))


def test_config_registry_covers_every_repo_config():
    """Each of the repo's config files has its port function."""
    files = sorted(
        f"configs/{d}/{n}" for d in os.listdir(os.path.join(ROOT, "configs"))
        if os.path.isdir(os.path.join(ROOT, "configs", d))
        for n in os.listdir(os.path.join(ROOT, "configs", d))
        if n.endswith(".py") and not n.startswith("_"))
    assert len(files) == 13 and sorted(tcfg.CONFIGS) == files


def test_config_registry_and_overrides_raise():
    with pytest.raises(KeyError, match="configs/gdrn/lm_base.py"):
        tcfg.load_config("configs/gdrn/nope.py")
    cfg = tcfg.apply_overrides(tcfg.gdrn_lm_base(), [
        "data.test_datasets=synthetic,lm", "model.num_classes=2",
        "data.label_cache=false", "solver.base_lr=0.5"])
    ref = jcfg.apply_overrides(_jax_config("configs/gdrn/lm_base.py"), [
        "data.test_datasets=synthetic,lm", "model.num_classes=2",
        "data.label_cache=false", "solver.base_lr=0.5"])
    _held_to(cfg, ref)
    with pytest.raises(KeyError, match="unknown config key"):
        tcfg.apply_overrides(cfg, ["data.nope=1"])


# ------------------------------------------------------------------ renders
def test_render_wrappers_match_jax():
    """rasterize_single (a batch of one), render_xyz_mask_depth and
    render_color against the JAX package's XLA path: masks equal, the rest
    within 1e-5."""
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation
    from self6dpp_tpu.ops import rasterizer as JR
    from self6dpp_tpu_torch.ops import rasterizer as TR
    v, f = tmeshes.make_icosphere(0.07, 2)
    colors = (v / 0.14 + 0.5).astype(np.float32)
    K = np.array([[120.0, 0, 40], [0, 120, 30], [0, 0, 1]], np.float32)
    R = Rotation.random(3, random_state=8).as_matrix().astype(np.float32)
    t = np.array([[0, 0, 0.6], [0.03, -0.02, 0.7], [-0.04, 0.01, 0.5]],
                 np.float32)
    kw = dict(height=60, width=80, tile_px=8, faces_per_tile=64)
    j = JR.rasterize_single(*(jnp.asarray(x) for x in (v, f, colors, K)),
                            jnp.asarray(R[0]), jnp.asarray(t[0]), **kw)
    p = TR.rasterize_single(v, f, colors, K, R[0], t[0], impl="plain",
                            device="cpu", **kw)
    assert np.array_equal(np.asarray(j.mask), p.mask.numpy())
    for name in ("depth", "attr", "prob"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    jx = JR.render_xyz_mask_depth(jnp.asarray(v), jnp.asarray(f),
                                  jnp.asarray(K), jnp.asarray(R),
                                  jnp.asarray(t), **kw)
    px = TR.render_xyz_mask_depth(v, f, K, R, t, impl="plain", device="cpu",
                                  **kw)
    jc = JR.render_color(jnp.asarray(v), jnp.asarray(f), jnp.asarray(colors),
                         jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), **kw)
    pc = TR.render_color(v, f, colors, K, R, t, impl="plain", device="cpu",
                         **kw)
    for ja, pa in ((jx, px), (jc, pc)):
        assert ja.keys() == pa.keys()
        assert np.array_equal(np.asarray(ja["mask"]), pa["mask"].numpy())
        for k in ja:
            np.testing.assert_allclose(pa[k].numpy(), np.asarray(ja[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
