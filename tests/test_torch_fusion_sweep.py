"""K6's order of work (csrc/fusion_nms.cu) on the CPU, against JAX.

The kernel does not follow JAX's loop (an argmax over the alive rows,
then n IoUs, per emitted cluster). It ranks the valid rows by a stable
sort on descending seed score, computes the "+1 IoU > threshold" bits of
every sorted pair (i, j > i) once, sweeps the sorted rows over alive bit
words 32 rows at a time (in the tile, the first alive row is the seed,
its cluster the alive bits of its mask row and itself; then the later
words drop the tile's seeds' clusters in seed order), marks each row with
its cluster as it leaves, and sums each cluster's columns over its rows
in index order. The kernel runs only on a card; this file holds a numpy
model of that order, in f32 arithmetic as the kernel's, to JAX's
``fusion_nms`` on the inputs of ``tests/test_torch_gdino._fusion_inputs``
(exact ties and rows of other classes among them): the sweep's seeds and
clusters equal those of JAX's argmax loop, and the fused rows equal
JAX's for all 9 method pairs (the same valid rows and classes; boxes,
scores and probs within 1e-5: the sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coin_tpu.ops import nms as jnms
from coin_tpu.structures import Detections as JDet
from tests.test_torch_gdino import _fusion_inputs

F32 = np.float32
NEG_INF = F32(-1e30)
THR = 0.5


def _setup(boxes, probs, classes, valid):
    """The class-offset boxes and seed scores of one image (f32)."""
    m = np.where(valid[:, None], boxes, F32(0)).max()
    step = F32(F32(m) + F32(1))
    shift = (np.maximum(classes, 0).astype(F32) * step).astype(F32)
    off = np.where(valid[:, None], boxes + shift[:, None], F32(0))
    cls0 = np.clip(classes, 0, probs.shape[1] - 1)
    scores = np.where(valid, probs[np.arange(len(valid)), cls0], NEG_INF)
    return off.astype(F32), scores.astype(F32)


def _iou_over(a, b, thr):
    """The kernel's ``iou_over``: +1 IoU of box a with each row of b, in
    its f32 order, > thr."""
    one = F32(1)
    w = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0])
                   + one, F32(0))
    h = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1])
                   + one, F32(0))
    inter = w * h
    uni = ((a[2] - a[0] + one) * (a[3] - a[1] + one)
           + (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(uni > 0, inter / uni, F32(0))
    return np.where(inter == 0, F32(0) > thr, iou > thr)


def _bits(word):
    """The 32 bits of a word, lowest first."""
    return (word >> np.arange(32)) & 1 == 1


def sweep_clusters(boxes, probs, classes, valid, thr=THR):
    """The kernel's phases 1-3 for one image: the rows' cluster numbers
    (-1 for none) and the seeds' row indices, in emission order."""
    off, scores = _setup(boxes, probs, classes, valid)
    n = len(valid)
    rows = np.flatnonzero(valid)
    # stable sort by descending score, ties by index
    perm = rows[np.argsort(-scores[rows], kind="stable")]
    nv = len(perm)
    ne = int((scores[perm] > NEG_INF / 2).sum())
    words = (nv + 31) // 32
    mask = np.zeros((nv, words), np.uint32)
    for r in range(nv):
        bits = np.zeros(words * 32, bool)
        bits[r + 1:nv] = _iou_over(off[perm[r]], off[perm[r + 1:]], thr)
        mask[r] = np.packbits(bits.reshape(words, 32)[:, ::-1],
                              axis=1).view(">u4")[:, 0]
    alive = np.zeros(words, np.uint32)
    for w in range(words):
        left = nv - 32 * w
        alive[w] = 0xFFFFFFFF if left >= 32 else (1 << left) - 1
    # the sweep, 32 sorted rows at a time: the tile's seeds from its own
    # word and its rows' diagonal words, then their clusters in the later
    # words in seed order; each row marked with its cluster as it leaves
    owner, seeds, stop = np.full(n, -1), [], False
    for t in range(words):
        a, tile_seeds = int(alive[t]), []
        while a:
            i = (a & -a).bit_length() - 1
            if 32 * t + i >= ne:            # JAX writes nothing from here
                stop = True
                break
            cl = a & (int(mask[32 * t + i, t]) | (1 << i))
            a &= ~cl
            tile_seeds.append(32 * t + i)
            owner[perm[32 * t + np.flatnonzero(_bits(cl))]] = len(seeds)
            seeds.append(32 * t + i)
        alive[t] = a
        k0 = len(seeds) - len(tile_seeds)
        for w in range(t + 1, words):
            for kk, sr in enumerate(tile_seeds):
                cl = int(alive[w]) & int(mask[sr, w])
                alive[w] = int(alive[w]) & ~cl & 0xFFFFFFFF
                owner[perm[32 * w + np.flatnonzero(_bits(cl))]] = k0 + kk
        if stop:
            break
    return owner, perm[seeds]


def argmax_clusters(boxes, probs, classes, valid, thr=THR):
    """JAX's loop (coin_tpu/ops/nms.py:199-217) in numpy: the rows'
    cluster numbers and the seeds."""
    off, scores = _setup(boxes, probs, classes, valid)
    alive = valid.copy()
    owner, seeds = np.full(len(valid), -1), []
    while True:
        cur = np.where(alive, scores, NEG_INF)
        top = int(np.argmax(cur))
        if not cur[top] > NEG_INF / 2:
            break
        cluster = alive & _iou_over(off[top], off, thr)
        cluster[top] = True
        owner[cluster] = len(seeds)
        seeds.append(top)
        alive &= ~cluster
    return owner, np.asarray(seeds, int)


def _seq_sum(values):
    """Σ in the order given, each sum rounded to f32."""
    acc = F32(0)
    for v in values:
        acc = F32(acc + v)
    return acc


def fuse(boxes, probs, classes, valid, score_method, box_method, thr=THR):
    """The kernel's output for one image: each cluster summed over its
    rows in index order, then the stable re-sort by fused score."""
    n, c1 = probs.shape
    owner, seeds = sweep_clusters(boxes, probs, classes, valid, thr)
    _, scores = _setup(boxes, probs, classes, valid)
    logp = np.log(np.maximum(probs, F32(1e-20))).astype(F32)
    fused = []
    for k, top in enumerate(seeds):
        rows = np.flatnonzero(owner == k)          # index order
        count = F32(max(len(rows), 1))
        if score_method == "probEn":
            s = np.array([_seq_sum(logp[rows, c]) for c in range(c1)], F32)
            e = np.exp(s - s.max()).astype(F32)
            fprob = (e / _seq_sum(e)).astype(F32)
            fscore = fprob[max(classes[top], 0)]
        elif score_method == "avg":
            fprob = np.array([_seq_sum(probs[rows, c]) for c in range(c1)],
                             F32) / count
            fscore = _seq_sum(scores[rows]) / count
        else:
            fprob, fscore = probs[top], scores[top]
        wsum = _seq_sum(scores[rows])
        if box_method == "s-avg":
            denom = max(wsum, F32(1e-20))
            fbox = np.array([_seq_sum(boxes[rows, i] * (scores[rows] / denom))
                             for i in range(4)], F32)
        elif box_method == "avg":
            fbox = np.array([_seq_sum(boxes[rows, i]) for i in range(4)],
                            F32) / count
        else:
            fbox = boxes[top]
        fused.append((fbox, F32(fscore), fprob, classes[top]))
    order = sorted(range(len(fused)), key=lambda k: -fused[k][1])
    out_b = np.zeros((n, 4), F32)
    out_s = np.zeros(n, F32)
    out_p = np.zeros((n, c1), F32)
    out_c = np.full(n, -1, np.int32)
    out_v = np.zeros(n, bool)
    for i, k in enumerate(order):
        out_b[i], out_s[i], out_p[i], out_c[i] = fused[k]
        out_v[i] = True
    return out_b, out_s, out_p, out_c, out_v


@pytest.mark.parametrize("n", [48, 100])
def test_sweep_picks_jax_seeds_and_clusters(n):
    """The sweep over sorted rows and mask words gives the argmax loop's
    seeds, in its order, and its clusters, row for row (n = 100: four
    alive words, the last one partial)."""
    rng = np.random.RandomState(0)
    boxes, probs, classes, valid = _fusion_inputs(rng, n=n)
    for i in range(len(boxes)):
        args = (boxes[i], probs[i], classes[i], valid[i])
        owner, seeds = sweep_clusters(*args)
        want_owner, want_seeds = argmax_clusters(*args)
        np.testing.assert_array_equal(seeds, want_seeds)
        np.testing.assert_array_equal(owner, want_owner)
        assert 1 < len(seeds) < int(valid[i].sum())   # clusters fused


@pytest.mark.parametrize("score_method", ["probEn", "avg", "max"])
@pytest.mark.parametrize("box_method", ["s-avg", "avg", "max"])
def test_sweep_order_matches_jax_fusion_nms(score_method, box_method):
    rng = np.random.RandomState(0)
    boxes, probs, classes, valid = _fusion_inputs(rng)
    scores = probs[..., :-1].max(-1)
    want = jax.vmap(lambda b, s, c, v, p: jnms.fusion_nms(
        JDet(b, s, c, v, p), THR, score_method, box_method))(
            *map(jnp.asarray, (boxes, scores, classes, valid, probs)))
    for i in range(len(boxes)):
        got_b, got_s, got_p, got_c, got_v = fuse(
            boxes[i], probs[i], classes[i], valid[i], score_method,
            box_method)
        np.testing.assert_array_equal(got_v, np.asarray(want.valid[i]))
        np.testing.assert_array_equal(got_c, np.asarray(want.classes[i]))
        for name, got, w in (("boxes", got_b, want.boxes[i]),
                             ("scores", got_s, want.scores[i]),
                             ("probs", got_p, want.probs[i])):
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
