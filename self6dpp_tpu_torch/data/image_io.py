"""PNG and JPEG reading, and PNG writing, on the standard library's zlib,
numpy and two host routines in C, in place of cv2.imread / cv2.imwrite (the
JAX package's data path). imread picks the format by the file's first
bytes, not by its extension.

Reads 8-bit gray, 8-bit RGB and RGBA (returned RGB, alpha dropped) and
16-bit gray (depth, returned uint16), non-interlaced, undoing all five
scanline filters. Raises, naming the file, on anything else: interlaced
images, palettes, gray with alpha, bit depths below 8 and 16-bit colour.
The filters are undone by a host routine in C (csrc/png_unfilter.c), built
at first use. Writes uint8 gray or RGB and uint16 gray, choosing each
row's filter as libpng does.

JPEG: baseline (sequential Huffman) files of 1 or 3 components, decoded by
csrc/jpeg_decode.c bit for bit as libjpeg-turbo's defaults decode them
(ISLOW IDCT, fancy upsampling, its fixed-point YCbCr tables), which is
what cv2.imread returns. Raises, naming the file, on progressive,
lossless, arithmetic-coded, 12-bit and CMYK files, and on an EXIF
orientation other than 1 (cv2.imread would rotate such an image).

Channel order: imread returns RGB, where cv2.imread(IMREAD_COLOR) returns
BGR; the JAX loader flips cv2's image to RGB, so both hold the same array.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8\xff"
# colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends without IEND")


_UNFILTER = []


def _unfilter_fn():
    """csrc/png_unfilter.c's png_unfilter, built at first use."""
    if not _UNFILTER:
        from ..kernels.build import load_host
        fn = load_host("png_unfilter").png_unfilter
        fn.argtypes = (ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64)
        fn.restype = ctypes.c_int
        _UNFILTER.append(fn)
    return _UNFILTER[0]


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """(height, stride) uint8 scanlines with their filters undone, in one
    pass of the host routine csrc/png_unfilter.c (Sub, Average and Paeth
    are sequential along a row)."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    out = np.empty((height, stride), np.uint8)
    bad = _unfilter_fn()(raw, out.ctypes.data, height, stride, bpp)
    if bad < 0:
        raise MemoryError(f"{path}: PNG unfilter could not allocate a row")
    if bad:
        ftype = raw[(bad - 1) * (stride + 1)]
        raise ValueError(f"{path}: unknown PNG filter type {ftype}")
    return out


def read_png(path: str) -> np.ndarray:
    """The image as stored: (H, W) uint8 or uint16 for gray, (H, W, 3)
    uint8 for RGB, (H, W, 4) uint8 for RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are not read")
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not read "
                         "(gray, RGB and RGBA are)")
    cn = _CHANNELS[ctype]
    if depth not in (8, 16) or (depth == 16 and cn != 1):
        raise ValueError(f"{path}: {depth}-bit PNG with {cn} channels is "
                         "not read (8-bit gray/RGB/RGBA and 16-bit gray are)")
    bpp = cn * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                   bpp, path)
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(height, width)
    return px.reshape(height, width, cn) if cn > 1 else \
        px.reshape(height, width)


_JPEG = []


def _jpeg_lib():
    """csrc/jpeg_decode.c's jpeg_info and jpeg_decode, built at first use."""
    if not _JPEG:
        from ..kernels.build import load_host
        lib = load_host("jpeg_decode")
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.jpeg_info.argtypes = (ctypes.c_char_p, i64, p, ctypes.c_char_p, i)
        lib.jpeg_info.restype = i
        lib.jpeg_decode.argtypes = (ctypes.c_char_p, i64, i, p,
                                    ctypes.c_char_p, i)
        lib.jpeg_decode.restype = i
        _JPEG.append(lib)
    return _JPEG[0]


def decode_jpeg(data: bytes, gray: bool | None = False,
                path: str = "<bytes>") -> np.ndarray:
    """A baseline JPEG's pixels: (H, W, 3) uint8 RGB; with gray, (H, W)
    uint8, Y of a YCbCr file (libjpeg's JCS_GRAYSCALE output); with gray
    None, as stored (gray for a one-component file, else RGB)."""
    lib = _jpeg_lib()
    err = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    if lib.jpeg_info(data, len(data), info.ctypes.data, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    h, w = int(info[0]), int(info[1])
    if gray is None:
        gray = int(info[2]) == 1
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), int(gray), out.ctypes.data, err,
                       len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


_JPEG_GRAY = {"color": False, "gray": True, "unchanged": None}


def read_jpeg(path: str, mode: str = "color") -> np.ndarray:
    """imread's modes on a JPEG file; 'unchanged' is gray (H, W) for a
    one-component file and RGB otherwise, as cv2.IMREAD_UNCHANGED reads."""
    if mode not in _JPEG_GRAY:
        raise ValueError(f"unknown imread mode: {mode!r}")
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), _JPEG_GRAY[mode], path)


def imread(path: str, mode: str = "unchanged") -> np.ndarray:
    """cv2.imread's modes on PNG and baseline JPEG files, the format told
    by the file's first bytes. 'color': (H, W, 3) uint8 RGB (gray repeated
    to three channels, alpha dropped); 'gray': (H, W) uint8 of an 8-bit
    gray PNG or of any JPEG (its Y); 'unchanged': as stored (read_png,
    read_jpeg), alpha dropped."""
    with open(path, "rb") as f:
        head = f.read(len(_SIGNATURE))
    if head.startswith(_JPEG_SOI):
        return read_jpeg(path, mode)
    img = read_png(path)
    if mode == "unchanged":
        return img[..., :3] if img.ndim == 3 else img
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit PNG read as {mode!r}; read it "
                         "'unchanged'")
    if mode == "color":
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 \
            else np.ascontiguousarray(img[..., :3])
    if mode == "gray":
        if img.ndim != 2:
            raise ValueError(f"{path}: colour PNG read as 'gray'")
        return img
    raise ValueError(f"unknown imread mode: {mode!r}")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, S) uint8: the rows (H, S) under each filter type 0-4, every
    byte against the unfiltered bytes to its left (a), above (b) and above
    left (c)."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
            & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, level: int = 6,
              filter_type: int | None = None) -> None:
    """Write (H, W) uint8 or uint16 gray, or (H, W, 3) uint8 RGB. Each row
    takes the filter of least sum of absolute (signed) bytes, as libpng's
    adaptive choice does (cv2.imwrite's default), or `filter_type` (0-4)
    for every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth = 2, 8
    elif img.dtype in (np.uint8, np.uint16) and img.ndim == 2:
        ctype, depth = 0, 8 * img.itemsize
    else:
        raise ValueError(f"{path}: cannot write a {img.dtype} image of shape "
                         f"{img.shape} (uint8 gray/RGB, uint16 gray)")
    if filter_type not in (None, 0, 1, 2, 3, 4):
        raise ValueError(f"unknown PNG filter type {filter_type!r}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(height, -1)
    every = _filtered(rows, rows.shape[1] // width)
    if filter_type is None:
        cost = np.minimum(every, 256 - every.astype(np.int32)).sum(axis=2)
        ftype = np.argmin(cost, axis=0)      # ties: the lower type
    else:
        ftype = np.full(height, filter_type)
    lines = np.concatenate([ftype.astype(np.uint8)[:, None],
                            every[ftype, np.arange(height)]], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
                + _chunk(b"IEND", b""))
