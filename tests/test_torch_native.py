"""The port's native JPEG decoder (``coin_tpu_torch.native``) and the
loaders' decode paths against the JAX package's on the CPU.

``decode_batch`` and ``jpeg_size`` are held to ``coin_tpu.native``'s bit
for bit (the same C++ arithmetic, built with the same flags), on the JPEGs
of ``tests/test_native_decoder.py``'s generator: prescaled downscales,
upscales and a canvas that clamps the resized image; an undecodable blob
gives None on both sides. The loaders, native path active on both sides:
``TestLoader`` and ``TrainLoader`` with and without ``aspect_buckets``
give identical batches for one seed (images, ``image_hw``, scales, flips,
indices and ground truth, exactly) over a mixed landscape/portrait JPEG
set whose 2-image portrait group is sampled with replacement at batch 3,
over records without their size (filled from the JPEG header), and over
a PNG set that both packages decode with PIL.

The tests skip only where g++ or libjpeg's header is missing, as the JAX
package's own decoder test does; with both present a failed build fails.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from coin_tpu import native as jnative
from coin_tpu.data import loader as jloader
from coin_tpu.data import voc as jvoc
from coin_tpu_torch import native as tnative
from coin_tpu_torch.data import loader as tloader
from coin_tpu_torch.data import voc as tvoc
from coin_tpu_torch.kernels.build import BUILD_DIR
from tests.test_native_decoder import _jpeg_bytes

CLASSES = ("car", "person")
FIELDS = ("indices", "flip", "image_hw", "orig_hw", "scale", "images",
          "gt_boxes", "gt_classes", "gt_valid", "gt_difficult")


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    gxx, header = tnative.toolchain()
    if gxx is None or not header:
        pytest.skip("g++ or jpeglib.h missing: the loaders decode with PIL")
    assert tnative.available(), tnative.build_error()
    assert jnative.available()


def test_library_builds_into_the_build_directory():
    """Into the git-ignored _build/, never beside the source."""
    assert tnative._LIB == os.path.join(BUILD_DIR, "libcoin_native.so")
    assert os.path.exists(tnative._LIB)
    here = os.listdir(os.path.dirname(tnative.__file__))
    assert set(here) - {"__pycache__"} == {"__init__.py", "decoder.cpp"}


@pytest.mark.parametrize("hw", [(48, 64), (200, 120), (17, 333)])
def test_jpeg_size_matches_jax(rng, hw):
    blob = _jpeg_bytes(rng, *hw)
    assert tnative.jpeg_size(blob) == jnative.jpeg_size(blob) == hw
    assert tnative.jpeg_size(b"not a jpeg") is None


@pytest.mark.parametrize("scales,canvas", [
    ((0.5, 0.75, 0.3), (64, 96)),      # DCT prescales 4/8, 6/8, 3/8
    ((1.7, 1.3, 0.9), (256, 256)),     # upscales: no prescale
    ((1.0, 1.0, 1.0), (80, 100))])     # clamped to the canvas
def test_decode_batch_equals_jax_bit_for_bit(rng, scales, canvas):
    blobs = [_jpeg_bytes(rng, 96, 128), _jpeg_bytes(rng, 64, 80),
             _jpeg_bytes(rng, 200, 120)]
    got = tnative.decode_batch(blobs, scales, canvas, num_threads=2)
    want = jnative.decode_batch(blobs, scales, canvas, num_threads=2)
    assert got[0].shape == (3, *canvas, 3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].any()
    for img, (nh, nw, _, _) in zip(got[0], got[1]):
        assert not img[nh:].any() and not img[:, nw:].any()
    bad = blobs[:1] + [b"\xff\xd8 broken"]
    assert tnative.decode_batch(bad, scales[:2], canvas) is None
    assert jnative.decode_batch(bad, scales[:2], canvas) is None


def _voc(root, split, n, hw, seed, ext=".jpg", drop_size=False):
    jvoc.make_synthetic_voc(str(root), num_images=n, image_hw=hw,
                            seed=seed, split=split)
    ids = open(os.path.join(root, "ImageSets/Main", split + ".txt")).read() \
        .split()
    for i in ids:
        if ext != ".jpg":
            jpg = os.path.join(root, "JPEGImages", i + ".jpg")
            Image.open(jpg).save(jpg[:-4] + ext)
        if drop_size:
            xml = os.path.join(root, "Annotations", i + ".xml")
            text = open(xml).read()
            start, end = text.index("<size>"), text.index("</size>") + 7
            open(xml, "w").write(text[:start] + text[end:])
    return ids


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A mixed set (5 landscape 72 x 112 and 2 portrait 112 x 72 JPEGs),
    3 JPEGs without their size in the XML and 3 PNGs, registered in both
    packages; removed after the module."""
    root = tmp_path_factory.mktemp("native")
    mixed = root / "mixed/VOC2007"
    ids = _voc(mixed, "land", 5, (72, 112), 1) \
        + _voc(mixed, "port", 2, (112, 72), 2)
    with open(mixed / "ImageSets/Main/all.txt", "w") as f:
        f.write("\n".join(ids) + "\n")
    _voc(root / "nosize/VOC2007", "train", 3, (80, 100), 3, drop_size=True)
    _voc(root / "png/VOC2007", "train", 3, (72, 112), 4, ext=".png")
    for reg in (jvoc.register_pascal_voc, tvoc.register_pascal_voc):
        reg("tnat_mixed", "mixed/VOC2007", "all", CLASSES, ".jpg")
        reg("tnat_nosize", "nosize/VOC2007", "train", CLASSES, ".jpg")
        reg("tnat_png", "png/VOC2007", "train", CLASSES, ".png")
    yield str(root)
    shutil.rmtree(root)


@pytest.fixture
def native_calls(monkeypatch):
    """Counts of each package's decode_batch calls."""
    calls = {"jax": 0, "port": 0}
    for name, mod in (("jax", jnative), ("port", tnative)):
        def counted(*a, _f=mod.decode_batch, _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, "decode_batch", counted)
    return calls


def assert_batches_equal(tb, jb):
    assert tb.image_ids == jb.image_ids
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                      err_msg=f)


@pytest.mark.parametrize("name,kw,native_used", [
    ("tnat_mixed", {}, True),
    ("tnat_nosize", dict(canvas_hw=(64, 96)), True),
    ("tnat_png", {}, False)])
def test_test_loader_batches_match_jax(data, native_calls, name, kw,
                                       native_used):
    kw = dict(batch_size=3, min_size=64, max_size=96, **kw)
    jl = jloader.TestLoader(name, data, **kw)
    tl = tloader.TestLoader(name, data, **kw)
    assert tuple(tl.canvas_hw) == tuple(jl.canvas_hw)
    batches = 0
    for (tb, tn), (jb, jn) in zip(tl, jl):
        assert tn == jn
        assert_batches_equal(tb, jb)
        batches += 1
    assert batches == len(jl) == len(tl)
    assert native_calls == dict.fromkeys(("jax", "port"),
                                         batches if native_used else 0)
    if name == "tnat_nosize":     # the size came from the JPEG's header
        assert [(r["height"], r["width"]) for r in tl.records] \
            == [(r["height"], r["width"]) for r in jl.records] \
            == [(80, 100)] * 3


@pytest.mark.parametrize("aspect_buckets", [False, True])
def test_train_loader_batches_match_jax(data, native_calls, aspect_buckets):
    kw = dict(batch_size=3, seed=5, min_size=64, max_size=96,
              aspect_buckets=aspect_buckets)
    jl = jloader.TrainLoader("tnat_mixed", data, **kw)
    tl = tloader.TrainLoader("tnat_mixed", data, **kw)
    canvases = set()
    for _, tb, jb in zip(range(6), tl._gen(), jl._gen()):
        assert_batches_equal(tb, jb)
        canvases.add(tb.images.shape[1:3])
        if aspect_buckets:    # one orientation per batch
            h, w = tb.orig_hw.T
            assert len(set((w >= h).tolist())) == 1
    assert native_calls == {"jax": 6, "port": 6}
    if aspect_buckets:
        assert canvases == {(64, 96), (96, 64)}
        assert tl._aspect_groups() == [[0, 1, 2, 3, 4], [5, 6]]
    else:
        assert canvases == {(96, 96)}
