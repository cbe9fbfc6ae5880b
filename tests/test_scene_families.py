"""Scene-family generator contract (accuracy-hardening round 5).

The per-family accuracy evidence (docs/ACCURACY.md) is only as good as
the generator's guarantees: determinism per (seed, index, family),
actual family characteristics (texture contrast, occlusion overlap),
and unchanged bit-identity of the default family (the judged sequences
of earlier rounds must remain reproducible).
"""

import numpy as np
import pytest

from rt_depth_map.sources import SyntheticStereoSource


def test_default_family_unchanged_fingerprint():
    """The 'default' family must render bit-identically to the
    pre-family generator (rounds 1-4 judged sequences): pinned
    fingerprint of frame 0 at the flagship accuracy seed."""
    src = SyntheticStereoSource(320, 240, seed=7)
    left, right, gt, boxes = src.render(0)
    fp = (int(left.astype(np.int64).sum()), int(right.astype(np.int64).sum()),
          float(gt.sum()))
    src2 = SyntheticStereoSource(320, 240, seed=7, scene="default")
    l2, r2, g2, b2 = src2.render(0)
    assert fp == (int(l2.astype(np.int64).sum()),
                  int(r2.astype(np.int64).sum()), float(g2.sum()))
    assert boxes == b2


@pytest.mark.parametrize("fam", ["default", "lowtex", "occlusion", "fine"])
def test_family_deterministic(fam):
    a = SyntheticStereoSource(160, 120, seed=3, scene=fam).render(2)
    b = SyntheticStereoSource(160, 120, seed=3, scene=fam).render(2)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)


def test_family_characteristics():
    W, H = 320, 240
    # lowtex: much lower BACKGROUND contrast than default. Measure an
    # object-free INTERIOR patch: objects only spawn at x,y >= extent/8,
    # and the generator's box blur darkens a ~3px zero-padded border that
    # would otherwise dominate the variance.
    d = SyntheticStereoSource(W, H, seed=5).render(0)[0][8:32, 8:36]
    lt = SyntheticStereoSource(W, H, seed=5,
                               scene="lowtex").render(0)[0][8:32, 8:36]
    assert np.std(lt.astype(np.float64)) < 0.5 * np.std(d.astype(np.float64))
    # fine: higher pixel-to-pixel gradient energy than default (no blur)
    fn = SyntheticStereoSource(W, H, seed=5, scene="fine").render(0)[0]
    g = lambda im: np.abs(np.diff(im.astype(np.int32), axis=1)).mean()  # noqa
    assert g(fn) > 2.0 * g(d)
    # occlusion: objects overlap (sum of box areas exceeds union area)
    src = SyntheticStereoSource(W, H, seed=5, scene="occlusion")
    _, _, _, boxes = src.render(0)
    assert len(boxes) == 8
    cover = np.zeros((H, W), bool)
    area_sum = 0
    for (x, y, w, h, _z) in boxes:
        cover[y : y + h, x : x + w] = True
        area_sum += w * h
    assert area_sum > 1.3 * cover.sum()  # heavy overlap


def test_unknown_family_rejected():
    with pytest.raises(ValueError):
        SyntheticStereoSource(64, 48, scene="nope")
