"""The port's PNG codec (`data/png.py`, `native/png.cpp`) and its PIL-equal
conversions and resizes (`ops/image.py`), held to PIL bit for bit, and the
fundus tree read through the port and through the JAX package.  PIL is the
oracle here, in the tests only: the port never imports it."""
import io
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ramdsir_tpu_torch import native
from ramdsir_tpu_torch.data import png
from ramdsir_tpu_torch.ops.image import convert, resize
from tests._torch_threads import torch_threads  # noqa: F401 (module-scoped autouse)

FILTER_CHOICES = (0, 1, 2, 3, 4, png.ADAPTIVE)
SIZES = ((11, 13), (1, 1), (3, 2), (9, 17))  # (height, width): odd widths leave partial bytes


def _pil_array(data: bytes):
    im = Image.open(io.BytesIO(data))
    return im, np.asarray(im)


def _assert_as_pil(data: bytes) -> None:
    """decode's mode and array, and convert("L" | "RGB"), against PIL's."""
    ours = png.decode(data)
    im, want = _pil_array(data)
    assert ours.mode == im.mode
    assert ours.array.dtype == want.dtype and ours.array.shape == want.shape
    np.testing.assert_array_equal(ours.array, want)
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(convert(ours, mode), np.asarray(im.convert(mode)), err_msg=mode)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) sample rows -> (h, rowbytes) PNG bytes at `depth` bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples.astype(np.int64), ((0, 0), (0, (-samples.shape[1]) % per))).reshape(h, -1, per)
    return (s << (8 - depth * (np.arange(per) + 1))).sum(-1).astype(np.uint8)


def _build(samples, ctype, depth, filter_type, interlace, palette=None, trns=None) -> bytes:
    """A PNG of any colour type and depth, built by hand: (H, W, C) samples,
    the row filter forced (or adaptive), Adam7 if asked, an ancillary tEXt
    chunk the decoder must skip."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = []
    for x0, y0, dx, dy, pw, ph in png._passes(w, h, interlace):
        rows = _pack(samples[y0::dy, x0::dx].reshape(ph, pw * ch), depth)
        raw.append(png.filter_rows(rows, bpp, filter_type).tobytes())
    out = [png.SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))),
           _chunk(b"tEXt", b"Comment\x00built by hand")]
    if palette is not None:
        out.append(_chunk(b"PLTE", palette.tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    data = zlib.compress(b"".join(raw))
    out += [_chunk(b"IDAT", data[: len(data) // 2]), _chunk(b"IDAT", data[len(data) // 2 :]), _chunk(b"IEND", b"")]
    return b"".join(out)


FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
           (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", FORMATS, ids=[f"type{c}-{d}bit" for c, d in FORMATS])
def test_decode_matches_pil_on_built_files(ctype, depth, interlace):
    """Every colour type and bit depth, each of the five filters forced and
    the adaptive choice, plain and Adam7, odd sizes; tRNS where the type
    has one."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = png._CHANNELS[ctype]
    for h, w in SIZES:
        for ft in FILTER_CHOICES:
            palette = trns = None
            top = 1 << depth
            if ctype == 3:
                top = min(top, 200)
                palette = rng.integers(0, 256, (top, 3), dtype=np.uint8)
                trns = bytes(rng.integers(0, 256, min(top, 7), dtype=np.uint8))
            samples = rng.integers(0, top, (h, w, ch))
            if depth == 16:  # small values too, below PIL's clip at 255
                samples = np.where(rng.random((h, w, ch)) < 0.5, samples % 300, samples)
            if ctype == 0:
                trns = struct.pack(">H", int(samples[0, 0, 0]))
            elif ctype == 2:
                trns = struct.pack(">HHH", *(int(v) for v in samples[0, 0]))
            _assert_as_pil(_build(samples, ctype, depth, ft, interlace, palette, trns))


def _pil_written(mode: str) -> bytes:
    rng = np.random.default_rng(1)
    rgb = Image.fromarray(rng.integers(0, 256, (23, 31, 3), dtype=np.uint8))
    kw = {}
    if mode == "I;16":
        im = Image.fromarray(np.where(rng.random((23, 31)) < 0.5, rng.integers(0, 256, (23, 31)),
                                      rng.integers(0, 65536, (23, 31))).astype(np.uint16))
    elif mode == "P_trns":
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=40)
        kw["transparency"] = bytes(range(0, 250, 25))
    elif mode == "P16":
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=16)
        kw["bits"] = 4
    elif mode == "P":
        im = rgb.convert("P", palette=Image.ADAPTIVE, colors=100)
    else:
        im = rgb.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["1", "L", "P", "P_trns", "P16", "LA", "RGB", "RGBA", "I;16"])
def test_decode_matches_pil_on_pil_files(mode):
    """Files PIL writes, in every mode it writes: the array PIL opens and
    its convert("L" | "RGB"), bit for bit.  16-bit gray converts as PIL's
    I;16 -> L / RGB does, clipped at 255 (pinned here)."""
    data = _pil_written(mode)
    _assert_as_pil(data)
    if mode == "I;16":
        ours = png.decode(data)
        np.testing.assert_array_equal(convert(ours, "L"), np.minimum(ours.array, 255))


@pytest.mark.parametrize("bpp", range(1, 9))
def test_native_unfilter_matches_plain(bpp):
    rng = np.random.default_rng(bpp)
    h, rowbytes = 9, bpp * 13 + 3 * (bpp == 1)
    filtered = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    filtered[:, 0] = rng.integers(0, 5, h)
    filtered[:5, 0] = np.arange(5)  # each filter at least once
    np.testing.assert_array_equal(native.png_unfilter(filtered, h, rowbytes, bpp),
                                  png.unfilter_plain(filtered, h, rowbytes, bpp))
    filtered[3, 0] = 5
    with pytest.raises(ValueError, match="row 3 has filter type 5"):
        native.png_unfilter(filtered, h, rowbytes, bpp)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_pil_and_the_port_read_the_encoder_exactly(mode):
    rng = np.random.default_rng(2)
    for h, w in SIZES:
        palette = None
        if mode == "P":
            palette = rng.integers(0, 256, (37, 3), dtype=np.uint8)
            arr = rng.integers(0, 37, (h, w), dtype=np.uint8)
        else:
            arr = rng.integers(0, 256, (h, w) if mode == "L" else (h, w, len(mode)), dtype=np.uint8)
        for ft in FILTER_CHOICES + tuple(png.FILTERS):
            data = png.encode(arr, palette=palette, filter_type=ft)
            im, got = _pil_array(data)
            assert im.mode == mode
            np.testing.assert_array_equal(got, arr)
            np.testing.assert_array_equal(png.decode(data).array, arr)
            if palette is not None:
                np.testing.assert_array_equal(np.asarray(im.getpalette(), np.uint8)[: palette.size], palette.ravel())


def test_adaptive_filter_uses_every_filter_on_a_natural_image():
    """The adaptive choice is per row: on a smooth ramp with noise it picks
    more than one filter."""
    rng = np.random.default_rng(3)
    ramp = (np.add.outer(np.arange(40), np.arange(50)) * 2 + rng.integers(0, 3, (40, 50))).astype(np.uint8)
    kinds = set(png.filter_rows(ramp, 1, png.ADAPTIVE)[:, 0].tolist())
    assert len(kinds) >= 2, kinds


def test_corrupt_files_raise_and_name_the_file(tmp_path):
    data = bytearray(png.encode(np.zeros((4, 5, 3), np.uint8)))
    data[45] ^= 0xFF  # a byte of IDAT's data (IHDR ends at 33, IDAT's data starts at 41)
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"bad\.png: CRC mismatch in chunk b'IDAT'"):
        png.decode(str(path))
    with pytest.raises(ValueError, match="not a PNG file"):
        png.decode(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="truncated"):
        png.decode(png.encode(np.zeros((4, 5), np.uint8))[:-20])


# --- resize ---------------------------------------------------------------------


def _assert_resize_as_pil(arr: np.ndarray, size) -> None:
    im = Image.fromarray(arr)
    for resample, name in ((Image.BILINEAR, "bilinear"), (Image.NEAREST, "nearest")):
        np.testing.assert_array_equal(resize(arr, size, name), np.asarray(im.resize(size, resample)),
                                      err_msg=f"{name} {arr.shape} -> {size}")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,size", [
    ((800, 800), (256, 256)), ((512, 512), (256, 256)), ((37, 53), (256, 256)), ((300, 411), (256, 256)),
    ((9, 7), (4, 13)), ((64, 64), (256, 256)), ((256, 256), (512, 512)), ((101, 99), (33, 201)),
])
def test_resize_matches_pil(src, size, channels):
    """Down and up, square and not, the fundus sizes (800 and 512 to 256)
    and odd ones; (height, width) in, PIL's (width, height) out."""
    rng = np.random.default_rng(sum(src) + channels)
    _assert_resize_as_pil(rng.integers(0, 256, src + ((3,) if channels == 3 else ()), dtype=np.uint8), size)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 160), w=st.integers(1, 160), oh=st.integers(1, 160), ow=st.integers(1, 160),
       rgb=st.booleans())
def test_resize_matches_pil_at_any_size(h, w, oh, ow, rgb):
    rng = np.random.default_rng(h * 1000 + w)
    _assert_resize_as_pil(rng.integers(0, 256, (h, w, 3) if rgb else (h, w), dtype=np.uint8), (ow, oh))


# --- the fundus tree through both packages ------------------------------------------


def _jax_tree(root, **kw):
    from ramdsir_tpu.data.synthetic import make_fundus_tree

    return make_fundus_tree(root, **kw)


def _port_tree(root, **kw):
    from ramdsir_tpu_torch.data.synthetic import make_fundus_tree

    return make_fundus_tree(root, filter_types=FILTER_CHOICES, palette_mask_domains=("Domain2",), **kw)


def test_port_tree_holds_the_jax_trees_arrays_and_manifests(tmp_path):
    """make_fundus_tree through the port's encoder (all filters, palette
    masks in one domain) and through the JAX package's PIL writer: the same
    files, names and manifests, and every file decodes (by PIL) to the same
    array."""
    kw = dict(per_domain_train=3, per_domain_test=2, size=24, seed=3)
    ours, theirs = _port_tree(str(tmp_path / "port"), **kw), _jax_tree(str(tmp_path / "jax"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), ours) for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs) for d, _, fs in os.walk(theirs) for f in fs)
    modes = set()
    for rel in files:
        a, b = os.path.join(ours, rel), os.path.join(theirs, rel)
        if rel.endswith(".list"):
            assert open(a).read() == open(b).read(), rel
            continue
        im = Image.open(a)
        modes.add(im.mode)
        want = np.asarray(Image.open(b).convert(im.mode if im.mode != "P" else "L"))
        np.testing.assert_array_equal(np.asarray(im.convert("L") if im.mode == "P" else im), want, err_msg=rel)
    assert modes == {"RGB", "L", "P"}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fundus_tree_reads_the_same_through_both_packages(tmp_path, writer):
    """The tree written by the port's encoder and by the JAX package's PIL
    writer in turn: the port's `DeviceFundusPipeline.from_tree` arrays and
    `FundusDataset` items equal the JAX package's, bit for bit."""
    from ramdsir_tpu.data.device_pipeline import DeviceFundusPipeline as JPipeline
    from ramdsir_tpu.data.fundus import FundusDataset as JFundusDataset
    from ramdsir_tpu.data.fundus import FundusMultiDataset as JDataset
    from ramdsir_tpu.data.transforms import Compose, Resize
    from ramdsir_tpu_torch.data.device_pipeline import DeviceFundusPipeline
    from ramdsir_tpu_torch.data.fundus import FundusDataset, FundusMultiDataset

    base = (_port_tree if writer == "port" else _jax_tree)(str(tmp_path), per_domain_train=9, per_domain_test=3,
                                                            size=37)
    size, bsl = 16, [2, 3, 4]
    jds = [JDataset(base, [d], test_domain_idx=3, resize_to=size) for d in (0, 1, 2)]
    jp = JPipeline(jds, bsl, base, size, 3, is_out_domain=True, seed=7, precompute_donor_amp=False)
    tds = [FundusMultiDataset(base, [d]) for d in (0, 1, 2)]
    tp = DeviceFundusPipeline.from_tree(tds, bsl, base, size, 3, is_out_domain=True, seed=7, device="cpu",
                                        precompute_donor_amp=False)
    for k in ("images", "masks", "donors"):
        np.testing.assert_array_equal(tp.device_data[k].numpy(), np.asarray(jp.device_data[k]).transpose(0, 3, 1, 2),
                                      err_msg=k)
    for dom in (1, 3):  # Domain2 holds the palette masks of the port's tree
        ours = FundusDataset(base, dom, size)
        theirs = JFundusDataset(base, dom, split="test", transform=Compose([Resize((size, size))]))
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a["id"] == b["id"]
            for k in ("img", "mask", "mask_orig"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{dom} {i} {k}")
