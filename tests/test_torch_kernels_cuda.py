"""coin_tpu_torch's CUDA kernels against their plain PyTorch versions on the
same card inputs. Needs a CUDA card and nvcc (the kernels have no CPU
mode), so every test here skips without one. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -q

Tolerances of the collection kernels: in their test's docstring; the
deformable 3x3 conv (K8) 1e-5 of the output's largest magnitude (the same
samples, the per-tap products summed in another order).
Tolerances: RoIAlign 1e-5 in f32 (the same arithmetic summed in another
order), NMS keep masks equal, normalisation 1e-6; the RoIAlign backward
(K1b) 1e-5 of the largest |d features| in f32 (its atomics add in no fixed
order); the strong and weak views (K4) 1e-5 (the canvas mean sums in
another order); the int8 convolutions (K2, K2s) and their quantisation bit
for bit: the same s8 values and scales (a NaN input gives a NaN scale and
s8 zeros on both), the same s32 sums (wrapping past 2**31), the same f32
rescale. The int8 RoIAlign (K5) and the IoU self-clustering (K11) bit for
bit (exact integer sums; the same IoU arithmetic and the same lowest
reachable index); the int8 RoIAlign backward (K5b) 1e-5 of the largest
|d features| in f32 and 2**-7 (two bf16 ulps) in bf16: its atomics add in
no fixed order, and a t near a bf16 rounding boundary may round to the
neighbouring value. The bilinear resize (K10a) 1e-5 relative and 1e-3
absolute in 0-255 units (the dense plain version sums every term of a
row in cuBLAS's order, the kernel its non-zero taps in ascending order);
the normalise + flip (K10b) bit for bit.
"""

import numpy as np
import pytest
import torch

from chip_smoke import clustered_boxes
from coin_tpu_torch.data import augment as taug
from coin_tpu_torch.ops import dedup as tdedup
from coin_tpu_torch.ops import nms as tnms
from coin_tpu_torch.ops import qconv as tq
from coin_tpu_torch.ops import roi_align as troi


def random_boxes(rng, n, size=100.0, min_wh=1.0, max_wh=40.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _roi_align_cases(rng, dev):
    for h, w in ((19, 38), (38, 19)):
        feats = torch.from_numpy(rng.randn(2, h, w, 64).astype(np.float32))
        rois = np.stack([random_boxes(rng, 50, 16.0 * max(h, w),
                                      max_wh=300.0) for _ in range(2)])
        rois[:, 0] = [-40.0, -30.0, 60.0, 50.0]               # partly outside
        rois[:, 1] = [16.0 * w - 30, 16.0 * h - 20, 16.0 * w + 90,
                      16.0 * h + 70]                          # past far edge
        rois[:, 2] = [33.0, 41.0, 33.5, 41.2]                 # tiny
        rois[:, 3] = [50.0, 50.0, 50.0, 50.0]                 # empty
        yield feats.to(dev), torch.from_numpy(rois).to(dev)


def _nms_cases(rng, dev):
    for case in ("random", "ties", "classes", "plus1"):
        boxes = np.stack([random_boxes(rng, 700, 300.0, 10.0)
                          for _ in range(3)])
        scores = rng.uniform(0, 1, (3, 700)).astype(np.float32)
        if case == "ties":
            scores = np.round(scores * 4) / 4
            boxes[:, 10:20] = boxes[:, :1]
        valid = rng.uniform(size=(3, 700)) > 0.2
        classes = (torch.from_numpy(rng.randint(0, 4, (3, 700))).to(dev)
                   if case == "classes" else None)
        yield (torch.from_numpy(boxes).to(dev),
               torch.from_numpy(scores).to(dev),
               torch.from_numpy(valid).to(dev), classes, case == "plus1")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["roi_align", "nms", "normalize"])
def test_kernel_matches_plain_version_on_card(cuda_device, which):
    rng = np.random.RandomState(0)
    if which == "roi_align":
        for feats, rois in _roi_align_cases(rng, cuda_device):
            got = troi.roi_align_batched(feats, rois, 1 / 16, 14, 2)
            want = troi.roi_align_plain(feats, rois, 1 / 16, 14, 2)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    elif which == "nms":
        for boxes, scores, valid, classes, plus1 in _nms_cases(
                rng, cuda_device):
            got = tnms.nms_keep_mask(boxes, scores, valid, 0.5,
                                     classes=classes, plus1=plus1)
            want = tnms.nms_keep_mask(
                boxes.cpu(), scores.cpu(), valid.cpu(), 0.5,
                classes=None if classes is None else classes.cpu(),
                plus1=plus1)
            assert torch.equal(got.cpu(), want)
            assert 0 < int(want.sum()) < int(valid.sum())
    else:
        # 3366 bytes: not a multiple of 4, so the kernel's tail runs too
        images = torch.randint(0, 256, (2, 33, 17, 3), dtype=torch.uint8,
                               device=cuda_device)
        torch.testing.assert_close(taug.normalize_batch(images),
                                   taug.normalize_plain(images),
                                   rtol=1e-6, atol=1e-6)


def _augment_draws(rng, gates):
    """(B, 9) draws with the four gates forced per image (1 = on)."""
    g = np.asarray(gates, np.float32)
    on = np.where(g != 0, 0.0, 0.99)
    rest = np.stack([rng.uniform(0.6, 1.4, len(g)),
                     rng.uniform(0.6, 1.4, len(g)),
                     rng.uniform(0.6, 1.4, len(g)),
                     rng.uniform(-0.1, 0.1, len(g)),
                     rng.uniform(0.1, 2.0, len(g))], 1)
    return torch.from_numpy(np.concatenate([on, rest], 1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["roi_align_bwd", "augment"])
def test_training_kernel_matches_plain_version_on_card(cuda_device, which):
    rng = np.random.RandomState(1)
    if which == "roi_align_bwd":
        for feats, rois in _roi_align_cases(rng, cuda_device):
            b, h, w, c = feats.shape
            g = torch.from_numpy(rng.randn(b, rois.shape[1], 14, 14, c)
                                 .astype(np.float32)).to(cuda_device)
            for dtype in (torch.float32, torch.bfloat16):
                got = troi.roi_align_backward(g.to(dtype), rois, feats.shape,
                                              torch.float32, 1 / 16, 14, 2)
                want = troi.roi_align_backward_plain(
                    g.to(dtype), rois, feats.shape, torch.float32, 1 / 16,
                    14, 2)
                tol = 1e-5 * float(want.abs().max())
                assert float((got - want).abs().max()) <= tol, dtype
            # through the autograd function, in f32
            want = troi.roi_align_backward_plain(g, rois, feats.shape,
                                                 torch.float32, 1 / 16, 14, 2)
            f = feats.clone().requires_grad_(True)
            troi.roi_align_batched(f, rois, 1 / 16, 14, 2).backward(g)
            torch.testing.assert_close(f.grad, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
    else:
        images = torch.from_numpy(rng.randint(0, 256, (16, 37, 53, 3))
                                  .astype(np.uint8)).to(cuda_device)
        gates = [[(i >> k) & 1 for k in range(4)] for i in range(16)]
        draws = _augment_draws(rng, gates)
        got = taug.preprocess_batch(images, draws)
        params = taug.augment_params(draws.to(cuda_device))
        want = taug.preprocess_plain(images, params)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roi_align_backward_footprints_on_card(cuda_device, dtype):
    """K1b's per-RoI footprints against the plain version, 1e-5 of the
    largest |d features| in f32 (one rounding of the gradient to bf16 for
    both in bf16): RoIs below one feature pixel, larger than the map, off
    the image and partly off it, at 1-4 samples, resolutions 7 and 14, and
    channel counts off the 32-channel blocks and the 4-channel vectors."""
    rng = np.random.RandomState(11)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    for (b, h, w, c), res, sampling in (((2, 38, 76, 64), 14, 2),
                                        ((1, 9, 13, 36), 7, 1),
                                        ((2, 11, 7, 6), 14, 3),
                                        ((1, 20, 30, 40), 7, 4)):
        n = 24
        xy = rng.uniform(-200, 16 * max(h, w) + 100, (b, n, 2))
        wh = rng.uniform(0.5, 16 * max(h, w) * 1.5, (b, n, 2))
        wh[:, :6] = rng.uniform(0.2, 12, (b, 6, 2))         # below a pixel
        xy[:, 6:9] = rng.uniform(-400, -300, (b, 3, 2))      # off the image
        xy[:, 9:12] = -64.0                                  # larger than
        wh[:, 9:12] = 16.0 * np.array([w, h]) + 128.0        # the map
        rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(cuda_device)
        g = torch.from_numpy(rng.randn(b, n, res, res, c)
                             .astype(np.float32)).to(cuda_device, dt)
        got = troi.roi_align_backward(g, rois, (b, h, w, c), torch.float32,
                                      1 / 16, res, sampling)
        want = troi.roi_align_backward_plain(g, rois, (b, h, w, c),
                                             torch.float32, 1 / 16, res,
                                             sampling)
        tol = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, (h, w, c, res)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roi_align_footprints_on_card(cuda_device, dtype):
    """K1's walk at the RoIs that bound it, against the plain version: RoIs
    below one feature pixel, larger than the map, off the image and partly
    off it, at 1-4 samples, resolutions 7 and 14, and channel counts off
    the 16-byte vectors (the scalar path) and off a block's channels; 1e-5
    in f32, one bf16 ulp of the larger of the two plus 1e-5 in bf16 (both
    sum in f32 in another order and round once)."""
    rng = np.random.RandomState(12)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    for (b, h, w, c), res, sampling in (((2, 38, 76, 64), 14, 2),
                                        ((1, 9, 13, 36), 7, 1),
                                        ((2, 11, 7, 6), 7, 3),
                                        ((1, 20, 30, 200), 7, 4),
                                        ((2, 38, 19, 1024), 14, 2)):
        n = 24
        xy = rng.uniform(-200, 16 * max(h, w) + 100, (b, n, 2))
        wh = rng.uniform(0.5, 16 * max(h, w) * 1.5, (b, n, 2))
        wh[:, :6] = rng.uniform(0.2, 12, (b, 6, 2))         # below a pixel
        xy[:, 6:9] = rng.uniform(-400, -300, (b, 3, 2))      # off the image
        xy[:, 9:12] = -64.0                                  # larger than
        wh[:, 9:12] = 16.0 * np.array([w, h]) + 128.0        # the map
        rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(cuda_device)
        feats = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)
                                 ).to(cuda_device, dt)
        got = troi.roi_align_batched(feats, rois, 1 / 16, res,
                                     sampling).float()
        want = troi.roi_align_plain(feats, rois, 1 / 16, res,
                                    sampling).float()
        tol = 1e-5
        if dt == torch.bfloat16:
            tol = torch.ldexp(torch.ones_like(want), torch.frexp(
                torch.maximum(got.abs(), want.abs())).exponent - 8) + 1e-5
        assert bool(((got - want).abs() <= tol).all()), (h, w, c, res)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one", "three", "odd"])
def test_augment_views_on_card(cuda_device, case):
    """K4 against its plain version (1e-5: the canvas mean sums in another
    order) for B = 1 and B = 3 at the training canvas and an odd canvas
    (H and W off the 16 x 64 tiles and W * 3 off 16 bytes), over every
    combination of the four gates; the strong-only call writes the strong
    view of the two-view call bit for bit and no weak view."""
    from coin_tpu_torch.kernels.augment import augment_cuda
    rng = np.random.RandomState(21)
    b, h, w = {"one": (1, 608, 1216), "three": (3, 608, 1216),
               "odd": (3, 37, 53)}[case]
    images = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3))
                              .astype(np.uint8)).to(cuda_device)
    gates = [[(i >> k) & 1 for k in range(4)] for i in range(16)]
    for i in range(0, 16, b):
        draws = _augment_draws(rng, (gates * 2)[i:i + b])
        params = taug.augment_params(draws.to(cuda_device))
        strong, weak = augment_cuda(images, params, taug.CLIP_MEAN,
                                    taug.CLIP_STD)
        want_s, want_w = taug.preprocess_plain(images, params)
        torch.testing.assert_close(strong, want_s, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(weak, want_w, rtol=1e-5, atol=1e-5)
        only, none = taug.preprocess_batch(images, draws, weak=False)
        assert none is None and torch.equal(only, strong)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roi_align_int8_backward_footprints_on_card(cuda_device, dtype):
    """K5b's per-RoI footprints against the plain version, 1e-5 of the
    largest |d features| in f32 and 2**-7 in bf16 (chip_smoke.py's
    tolerances): RoIs below one feature pixel, larger than the map (more
    footprint rows than one band), off the image, partly off it, and one
    that reaches columns but no row; 1-4 samples, resolutions 7, 14 and 20
    (the 8-channel chunks above 16), 1024 channels and 20 (the scalar
    path)."""
    from coin_tpu_torch.kernels.roi_align import roi_align_int8_backward_cuda
    rng = np.random.RandomState(22)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    for (b, h, w, c), res, sampling in (((2, 38, 76, 1024), 14, 2),
                                        ((2, 38, 19, 20), 14, 2),
                                        ((1, 9, 13, 36), 7, 1),
                                        ((2, 11, 7, 6), 14, 3),
                                        ((1, 20, 30, 40), 7, 4),
                                        ((1, 40, 12, 64), 20, 1)):
        n = 24
        xy = rng.uniform(-200, 16 * max(h, w) + 100, (b, n, 2))
        wh = rng.uniform(0.5, 16 * max(h, w) * 1.5, (b, n, 2))
        wh[:, :6] = rng.uniform(0.2, 12, (b, 6, 2))         # below a pixel
        xy[:, 6:9] = rng.uniform(-400, -300, (b, 3, 2))      # off the image
        xy[:, 9:12] = -64.0                                  # larger than
        wh[:, 9:12] = 16.0 * np.array([w, h]) + 128.0        # the map
        xy[:, 12] = [-30.0, 16.0 * h + 40.0]                 # no row
        wh[:, 12] = [40.0, 20.0]
        rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                                .astype(np.float32)).to(cuda_device)
        g = torch.from_numpy(rng.randn(b, n, res, res, c).astype(np.float32)
                             ).to(cuda_device, dt)
        got = roi_align_int8_backward_cuda(g, rois, (b, h, w, c), dt,
                                           1 / 16, res, sampling).float()
        want = troi.roi_align_int8_backward_plain(
            g, rois, (b, h, w, c), dt, 1 / 16, res, sampling).float()
        tol = 1e-5 if dt == torch.float32 else 2.0 ** -7
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (h, w, c, res, err)


def _nms_edge_cases(rng):
    """Sorted boxes and counts that K3's tiles must get right: a
    suppression chain across 64-row tiles, counts off the tiles, an image
    with no valid box and one with one, and boxes whose IoU with the first
    lies within a few ulps of the threshold."""
    n = 300
    x = 3.0 * np.arange(n, dtype=np.float32)
    chain = np.stack([x, np.zeros(n, np.float32), x + 10.0,
                      np.full(n, 10.0, np.float32)], -1) + 1.0
    yield chain[None], np.array([n], np.int32), 0.5
    boxes = np.stack([random_boxes(rng, 700, 300.0, 10.0) + 1.0
                      for _ in range(4)])
    yield boxes, np.array([131, 0, 1, 699], np.int32), 0.7
    # IoU of box 0 (width 10) with box i (width w_i) is 10 / w_i
    w = np.float32(10.0 / 0.7) * (1 + np.linspace(-2e-7, 2e-7, 63))
    widths = np.concatenate([[10.0], w.astype(np.float32)])
    near = np.stack([np.ones(64), np.ones(64), 1.0 + widths,
                     np.full(64, 11.0)], -1).astype(np.float32)
    yield near[None], np.array([64], np.int32), 0.7


@pytest.mark.cuda
def test_nms_edge_cases_on_card(cuda_device):
    """K3 on the sorted boxes of ``_nms_edge_cases`` keeps what the plain
    version keeps, half-open and inclusive widths."""
    from coin_tpu_torch.kernels.nms import nms_sorted_cuda
    rng = np.random.RandomState(13)
    for boxes, counts, thr in _nms_edge_cases(rng):
        sb = torch.from_numpy(boxes).to(cuda_device)
        cnt = torch.from_numpy(counts).to(cuda_device)
        for plus1 in (False, True):
            got = nms_sorted_cuda(sb, cnt, thr, plus1)
            want = tnms.nms_sorted_plain(sb.cpu(), cnt.cpu(), thr, plus1)
            assert torch.equal(got.cpu(), want), (boxes.shape, plus1)


def _s8(rng, shape, dev, lo=-127, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["quantize", "quantize_nan", "qconv",
                                   "qconv_wgrad"])
def test_int8_kernel_matches_plain_version_on_card(cuda_device, which):
    from coin_tpu_torch.kernels import qconv as kq
    rng = np.random.RandomState(2)
    dev = cuda_device

    def same(a, b):                       # NaN scales count as equal
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    if which == "quantize_nan":
        # a NaN makes its segment's scale NaN and its s8 values 0, as JAX
        for shape in ((5, 6, 6, 64), (3, 5, 7, 3)):
            x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
            x[1, 2, 3, 1] = float("nan")
            for dtype in (torch.float32, torch.bfloat16):
                for per_sample in (False, True):
                    xd = x.to(dev, dtype)
                    q, s = kq.quantize_cuda(xd, per_sample)
                    wq, ws = tq.quantize_plain(xd, per_sample)
                    assert torch.equal(q, wq) and same(s, ws)
                    assert int(s.isnan().sum()) == 1 and not q[1].any()
        w = torch.from_numpy(rng.randn(24, 36, 3, 3).astype(np.float32))
        w[5, 7, 1, 2] = float("nan")
        got = kq.quantize_weight_cuda(w.to(dev))
        want = tq.quantize_weight_plain(w.to(dev))
        assert torch.equal(got[0], want[0]) and same(got[1], want[1])
        assert int(got[1].isnan().sum()) == 1
        got = kq.quantize_weight_pair_cuda(w.to(dev))
        want = tq.quantize_weight_pair_plain(w.to(dev))
        assert torch.equal(got[0], want[0]) and same(got[1], want[1])
        assert torch.equal(got[2], want[2]) and same(got[3], want[3])
        assert int(got[3].isnan().sum()) == 1
        # the layout written beside the s8 values carries the NaN's zeros
        x = torch.from_numpy(rng.randn(130, 7, 7, 64).astype(np.float32))
        x[3, 2, 1, 0] = float("nan")
        q, s, lay = kq.quantize_cuda(x.to(dev, torch.bfloat16), False, 3)
        assert bool(s.isnan().all()) and not q.any() and not lay.any()
    elif which == "quantize":
        # vector path (sizes a multiple of 8) and the scalar one (odd)
        for shape in ((5, 6, 6, 64), (3, 5, 7, 3)):
            x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
            x[1] *= 1e-3
            for dtype in (torch.float32, torch.bfloat16):
                for per_sample in (False, True):
                    xd = x.to(dev, dtype)
                    q, s = kq.quantize_cuda(xd, per_sample)
                    wq, ws = tq.quantize_plain(xd, per_sample)
                    assert torch.equal(q, wq) and torch.equal(s, ws)
        # with K2 wgrad's layout: k = 1 and 3, N off the 128-image blocks,
        # channels off the 64-channel tiles and off the 8-channel vectors
        for n, h, w, c, k in ((5, 6, 6, 64, 3), (130, 7, 7, 12, 3),
                              (3, 5, 7, 8, 1), (300, 3, 5, 4, 1),
                              (37, 14, 14, 1024, 1), (131, 7, 7, 512, 3)):
            x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dev, dtype)
                q, s, lay = kq.quantize_cuda(xd, False, k)
                wq, ws = tq.quantize_plain(xd)
                assert torch.equal(q, wq) and torch.equal(s, ws)
                assert torch.equal(lay, tq.wgrad_layout_plain(wq, k)), \
                    (n, h, w, c, k, dtype)
        for o, i, k in ((8, 16, 3), (40, 3, 3), (24, 36, 1), (72, 100, 3),
                        (2048, 512, 1)):
            w = torch.from_numpy(rng.randn(o, i, k, k).astype(np.float32))
            got = kq.quantize_weight_cuda(w.to(dev))
            want = tq.quantize_weight_plain(w.to(dev))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            got = kq.quantize_weight_pair_cuda(w.to(dev))
            want = tq.quantize_weight_pair_plain(w.to(dev))
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                (o, i, k)
    elif which == "qconv":
        # (N, H, W, C, O, k, stride): res5-like, ragged tiles, the stem;
        # then the wgmma GEMM's paths: res5's 1x1 and both 3x3 shapes with
        # N off the 128-row tiles, C = 32, 48 and 64 (several taps in one
        # 128-byte stage, a last stage past K), O off the 64, 128 and 256
        # column tiles and rows of bf16 off 16 bytes (the per-warp
        # epilogue), stride 2, N = 1; and the direct kernel at the stem's
        # geometry on an odd image and at other channel counts; each in f32
        # and bf16, with one row scale and with one per sample
        for n, h, w, c, o, k, st in ((3, 14, 14, 64, 200, 3, 1),
                                     (2, 7, 9, 32, 48, 1, 1),
                                     (2, 19, 23, 3, 32, 3, 2),
                                     (1, 12, 12, 48, 136, 3, 2),
                                     (37, 14, 14, 1024, 512, 1, 1),
                                     (37, 14, 14, 512, 512, 3, 1),
                                     (91, 7, 7, 512, 512, 3, 1),
                                     (5, 7, 7, 2048, 300, 1, 1),
                                     (3, 15, 17, 32, 64, 3, 1),
                                     (2, 13, 11, 48, 72, 3, 1),
                                     (4, 16, 10, 64, 260, 1, 2),
                                     (1, 9, 9, 128, 96, 3, 2),
                                     (1, 37, 61, 3, 32, 3, 2),
                                     (2, 11, 9, 5, 40, 3, 1),
                                     (1, 8, 8, 20, 16, 1, 1)):
            xq = _s8(rng, (n, h, w, c), dev)
            wq = _s8(rng, (o, k, k, c), dev)
            cs = torch.from_numpy(rng.uniform(1e-3, 1e-2, o)
                                  .astype(np.float32)).to(dev)
            for rs in (torch.tensor([0.02], device=dev),
                       torch.from_numpy(rng.uniform(1e-3, 1e-1, n)
                                        .astype(np.float32)).to(dev)):
                for dt in (torch.float32, torch.bfloat16):
                    got = kq.qconv_fwd_cuda(xq, wq, rs, cs, st, k // 2, dt)
                    want = tq.qconv_plain(xq, wq, rs, cs, st, k // 2, dt)
                    assert got.dtype == dt and torch.equal(got, want), \
                        (n, h, w, c, o, k, st, rs.numel(), dt)
    else:
        # ragged tiles, then both 3x3 res5 shapes with N off the tiles
        for n, h, w, i, o, k in ((5, 14, 14, 64, 136, 3), (3, 7, 7, 36, 20, 1),
                                 (40, 14, 14, 16, 8, 3),
                                 (37, 14, 14, 512, 512, 3),
                                 (91, 7, 7, 512, 512, 3)):
            xq, gq = _s8(rng, (n, h, w, i), dev), _s8(rng, (n, h, w, o), dev)
            xs = torch.tensor([0.03], device=dev)
            gs = torch.tensor([1e-4], device=dev)
            got = kq.qconv_wgrad_cuda(tq.wgrad_layout_plain(xq, k),
                                      tq.wgrad_layout_plain(gq, k), xs, gs,
                                      n, h, w, k)
            want = tq.qconv_wgrad_plain(xq, gq, xs, gs, k)
            assert torch.equal(got, want), (n, h, w, i, o, k)
        # sums past 2**31 wrap as s32 sums do
        xq = torch.full((35, 64, 64, 4), 127, dtype=torch.int8, device=dev)
        one = torch.ones(1, device=dev)
        xt = tq.wgrad_layout_plain(xq, 1)
        got = kq.qconv_wgrad_cuda(xt, xt, one, one, 35, 64, 64, 1)
        want = tq.qconv_wgrad_plain(xq, xq, one, one, 1)
        assert torch.equal(got, want) and float(want.max()) < 0


@pytest.mark.cuda
@pytest.mark.parametrize("qt", [1, 2, 3, 4])
def test_int8_train_conv_on_card_matches_cpu(cuda_device, qt):
    """The autograd function on the card (kernels) against the CPU (plain
    versions) on bf16 res5-like inputs: forward and int8 gradients bit for
    bit; the exact gradients (cuDNN against the CPU) within two bf16 ulps
    of their largest entry."""
    rng = np.random.RandomState(qt)
    x = torch.from_numpy(rng.randn(6, 14, 14, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(96, 64, 3, 3) / 24).astype(np.float32))
    g = torch.from_numpy(rng.randn(6, 14, 14, 96).astype(np.float32))
    flags = (qt == 1, qt in (3, 4), qt != 4)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        xd = x.to(dev, torch.bfloat16).requires_grad_(True)
        wd = w.to(dev).requires_grad_(True)
        y = tq.int8_train_conv(xd, wd, 1, *flags)
        y.backward(g.to(dev))
        res[dev.type] = [t.detach().float().cpu() for t in (y, xd.grad,
                                                             wd.grad)]
    for name, a, b, exact in zip(("y", "dx", "dw"), res["cuda"], res["cpu"],
                                 (True, flags[2], flags[0])):
        if exact:
            assert torch.equal(a, b), name
        else:
            tol = 2.0 ** -7 * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol, name


def _fusion_case(rng, n=256, c1=9, b=4):
    """Clusters of overlapping boxes of one and of two classes, exact score
    ties, identical rows and invalid rows."""
    centres = rng.uniform(40, 560, (b, 12, 2))
    pick = rng.randint(0, 12, (b, n))
    xy = np.take_along_axis(centres, pick[..., None], 1) \
        + rng.uniform(-12, 12, (b, n, 2))
    wh = rng.uniform(30, 80, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = rng.dirichlet(np.ones(c1), (b, n)).astype(np.float32)
    probs[:, 10:20] = probs[:, :1]                        # exact ties
    boxes[:, 10:20] = boxes[:, :1]
    classes = probs[..., :-1].argmax(-1).astype(np.int32)
    classes[:, 30:60] = rng.randint(0, c1 - 1, (b, 30))   # not the argmax
    valid = rng.uniform(size=(b, n)) > 0.15
    classes[~valid] = -1
    return boxes, probs, classes, valid


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["window_attention", "ms_deform",
                                   "fusion_nms"])
def test_collection_kernel_matches_plain_version_on_card(cuda_device, which):
    """K9 in f32 (1e-5) and bf16 (2 bf16 ulps of the largest output), with
    and without the shift mask; K7 in f32 (1e-5) and on bf16 values within
    one bf16 rounding of the plain version run in f32 (the kernel computes
    in f32 and rounds once; JAX's order rounds every tap to bf16);
    K6 for all 9 method pairs: the same valid rows and classes, boxes,
    scores and probs within 1e-5 (sums and logs in another order)."""
    from coin_tpu_torch.models import deformable as tdef
    from coin_tpu_torch.models import swin as tswin
    rng = np.random.RandomState(3)
    dev = cuda_device
    if which == "window_attention":
        # Swin-B's first stage, the tiny Swin-T's n = 49 at d = 32 and 64,
        # Swin-L's 6 heads at n = 144, and 5 heads of 6 windows: 30
        # window-heads, an odd count (the bf16 kernel takes one a block, a
        # window's heads in neighbouring blocks)
        for heads, d, win, windows, shift in ((4, 32, 12, 6, 6),
                                              (3, 32, 7, 4, 0),
                                              (2, 64, 7, 4, 3),
                                              (6, 32, 12, 4, 6),
                                              (5, 32, 12, 3, 0)):
            n = win * win
            qkv = torch.from_numpy(rng.randn(2 * windows, n, 3, heads, d)
                                   .astype(np.float32)).to(dev)
            table = torch.from_numpy(rng.randn((2 * win - 1) ** 2, heads)
                                     .astype(np.float32)).to(dev)
            index = torch.from_numpy(tswin._rel_pos_index(win)).to(dev)
            side = int(np.sqrt(windows)) * win
            mask = (torch.from_numpy(tswin._attn_mask(side, side, win, shift))
                    .to(dev) if shift else None)
            for dtype in (torch.float32, torch.bfloat16):
                got = tswin.window_attention(qkv.to(dtype), table, index,
                                             mask).float()
                want = tswin.window_attention_plain(qkv.to(dtype), table,
                                                    index, mask).float()
                tol = (1e-5 if dtype == torch.float32
                       else 2.0 ** -7 * float(want.abs().max()))
                assert float((got - want).abs().max()) <= tol, (n, dtype)
    elif which == "ms_deform":
        shapes = [(19, 38), (10, 19), (5, 10), (3, 5)]
        starts = np.cumsum([0] + [h * w for h, w in shapes[:-1]]).tolist()
        total = sum(h * w for h, w in shapes)
        values = torch.from_numpy(rng.randn(2, total, 8, 32)
                                  .astype(np.float32)).to(dev)
        loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (2, 300, 8, 4, 4, 2))
                               .astype(np.float32)).to(dev)
        attw = torch.softmax(torch.from_numpy(
            rng.randn(2, 300, 8, 16).astype(np.float32)), -1).reshape(
                2, 300, 8, 4, 4).to(dev)
        got = tdef.ms_deform_sample(values, shapes, starts, loc, attw)
        want = tdef.ms_deform_sample_plain(values, shapes, starts, loc, attw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        # bf16 values: the kernel computes in f32 and rounds once
        vb = values.to(torch.bfloat16)
        got = tdef.ms_deform_sample(vb, shapes, starts, loc, attw)
        want = tdef.ms_deform_sample_plain(vb.float(), shapes, starts, loc,
                                           attw)
        torch.testing.assert_close(got.float(), want.to(torch.bfloat16)
                                   .float(), rtol=2.0 ** -8, atol=1e-5)
    else:
        from coin_tpu_torch.structures import Detections
        boxes, probs, classes, valid = (torch.from_numpy(a).to(dev) for a in
                                        _fusion_case(rng))
        det = Detections(boxes=boxes, scores=probs.amax(-1), classes=classes,
                         valid=valid, probs=probs)
        for sm in tnms.SCORE_METHODS:
            for bm in tnms.BOX_METHODS:
                got = tnms.fusion_nms(det, 0.6, sm, bm)
                want = tnms.fusion_nms(det.map(lambda t: t.cpu()), 0.6, sm,
                                       bm)
                assert torch.equal(got.valid.cpu(), want.valid), (sm, bm)
                assert torch.equal(got.classes.cpu(), want.classes), (sm, bm)
                for f in ("boxes", "scores", "probs"):
                    torch.testing.assert_close(
                        getattr(got, f).cpu(), getattr(want, f), rtol=1e-5,
                        atol=1e-5, msg=f"{sm} {bm} {f}")
                assert 0 < int(want.valid.sum()) < int(valid.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_matches_plain_version_on_card(cuda_device, stride):
    """K8 at GLIP's width (256 -> 256) on odd sizes, with taps outside the
    map, a non-unit mask and a bias; f32 with TF32 off for the plain
    version's einsum."""
    from coin_tpu_torch.device import parity_numerics
    from coin_tpu_torch.models import glip as tglip
    parity_numerics()
    rng = np.random.RandomState(4)
    h, w = 19, 38
    ho, wo = -(-h // stride), -(-w // stride)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    x = t(rng.randn(3, h, w, 256))
    offsets = t(rng.uniform(-3, 3, (3, ho, wo, 18)))
    mask = t(1 / (1 + np.exp(-rng.randn(3, ho, wo, 9))))
    kernel = t(rng.randn(3, 3, 256, 256) / 48)
    bias = t(rng.randn(256) * 0.1)
    got = tglip.deform_conv3x3(x, offsets, mask, kernel, bias, stride)
    want = tglip.deform_conv3x3_plain(x, offsets, mask, kernel, bias, stride)
    assert got.shape == (3, ho, wo, 256)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    none = tglip.deform_conv3x3(x, offsets, mask, kernel, None, stride)
    torch.testing.assert_close(none + bias, got, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_int8_matches_plain_version_on_card(cuda_device, dtype):
    """K5 bit for bit in both contraction orders, K5b at the stated
    tolerance, on the card's own inputs; 12 channels take the kernels'
    one-channel-per-thread path."""
    from coin_tpu_torch.kernels.roi_align import (
        roi_align_int8_backward_cuda, roi_align_int8_cuda)
    rng = np.random.RandomState(5)
    cases = list(_roi_align_cases(rng, cuda_device))
    cases.append((cases[0][0][..., :12].contiguous(), cases[0][1]))
    for feats, rois in cases:
        feats = feats.to(dtype)
        got = roi_align_int8_cuda(feats, rois, 1 / 16, 14, 2)
        want = troi.roi_align_int8_plain(feats, rois, 1 / 16, 14, 2)
        assert torch.equal(got, want)
        g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(
            cuda_device, dtype)
        shape = tuple(feats.shape)
        got = roi_align_int8_backward_cuda(g, rois, shape, dtype, 1 / 16,
                                           14, 2).float()
        want = troi.roi_align_int8_backward_plain(g, rois, shape, dtype,
                                                  1 / 16, 14, 2).float()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.9, 0.5])
def test_self_cluster_matches_plain_version_on_card(cuda_device, thr):
    """K11's keep and rep equal the plain closure's on clustered boxes."""
    from coin_tpu_torch.kernels.dedup import self_cluster_cuda
    rng = np.random.RandomState(11)
    for n in (5, 512, 700):
        pairs = [clustered_boxes(rng, n, thr) for _ in range(4)]
        boxes = torch.from_numpy(np.stack([p[0] for p in pairs])).to(
            cuda_device)
        valid = torch.from_numpy(np.stack([p[1] for p in pairs])).to(
            cuda_device)
        keep, rep = self_cluster_cuda(boxes, valid, thr)
        want_keep, want_rep = tdedup.self_cluster_index_plain(boxes, valid,
                                                              thr)
        assert torch.equal(keep, want_keep) and torch.equal(rep, want_rep)


@pytest.mark.cuda
@pytest.mark.parametrize("h0,w0,scale,out_hw,dtype", [
    (1024, 2048, 600 / 1024, (608, 1216), torch.uint8),
    (200, 300, 1.5, (304, 448), torch.float32),
    (100, 150, float(np.float32(0.305)), (32, 48), torch.uint8),
    (77, 131, 0.21, (24, 32), torch.float32),
], ids=["foggy", "up1.5", "f32-tie", "down0.21"])
def test_resize_bilinear_matches_plain_version_on_card(
        cuda_device, h0, w0, scale, out_hw, dtype):
    """K10a against its dense plain version: the same taps summed over
    the non-zero ones only; 1e-5 relative and 1e-3 absolute (0-255
    units), and the zeros past the scaled extent equal."""
    from coin_tpu_torch.ops import preprocess as tpre
    rng = np.random.RandomState(12)
    img = torch.from_numpy(rng.uniform(0, 256, (h0, w0, 3))).to(dtype) \
        .to(cuda_device)
    got = tpre.resize_bilinear(img, scale, out_hw)
    want = tpre.resize_bilinear_plain(img, scale, out_hw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got == 0, want == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [[True, False, True], [True] * 3,
                                  [False] * 3], ids=["mixed", "all", "none"])
def test_normalize_flip_matches_plain_version_on_card(cuda_device, flip):
    """K10b bit for bit against its plain version (odd widths included)."""
    from coin_tpu_torch.ops import preprocess as tpre
    images = torch.randint(0, 256, (3, 33, 17, 3), dtype=torch.uint8,
                           device=cuda_device)
    mean, std = (0.481, 0.457, 0.408), (0.268, 0.261, 0.275)
    flags = torch.tensor(flip, device=cuda_device)
    assert torch.equal(tpre.normalize_flip(images, flags, mean, std),
                       tpre.normalize_flip_plain(images, flags, mean, std))
