"""coin_tpu_torch's CUDA kernels against their plain PyTorch versions on the
same card inputs. Needs a CUDA card and nvcc (the kernels have no CPU
mode), so every test here skips without one. This file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -q

Tolerances: RoIAlign 1e-5 in f32 (the same arithmetic summed in another
order), NMS keep masks equal, normalisation 1e-6; the RoIAlign backward
(K1b) 1e-5 of the largest |d features| in f32 (its atomics add in no fixed
order); the strong and weak views (K4) 1e-5 (the canvas mean sums in
another order).
"""

import numpy as np
import pytest
import torch

from coin_tpu_torch.data import augment as taug
from coin_tpu_torch.ops import nms as tnms
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
