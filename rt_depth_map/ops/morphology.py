"""Morphological erode/dilate with elliptical structuring elements.

Re-creates the SWMorphologicalFilter stage (reference mf-sw.cpp:19-28):
opening then closing (erode->dilate->dilate->erode) with a 10x10 ellipse
(MORPH_FILTER_DX/DY=10, mf-sw.h:11-12).

Formulation: the elliptical footprint is decomposed into per-row horizontal
segments; each segment is a 1-D `lax.reduce_window` min/max and rows combine
with elementwise min/max. That keeps everything on the VPU with static
shapes -- no gather, no masked conv. Border semantics follow OpenCV's
morphology default (erode pads +inf -> 255, dilate pads -inf -> 0).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """cv::getStructuringElement(MORPH_ELLIPSE, (width, height)) parity."""
    r = height // 2
    c = width // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((height, width), dtype=np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            t = c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))
            dx = int(np.round(t))  # saturate_cast<int>: round to nearest
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, width)
            kernel[i, j1:j2] = 1
    return kernel


def _row_segments(kernel: np.ndarray):
    """(dy, dx_left, dx_right) per nonzero kernel row, relative to anchor."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    segs = []
    for i in range(kh):
        cols = np.nonzero(kernel[i])[0]
        if cols.size:
            segs.append((i - ay, int(cols[0]) - ax, int(cols[-1]) - ax))
    return segs


def _shift_cols(x: jnp.ndarray, n: int, pad_val) -> jnp.ndarray:
    """out[:, i] = x[:, i + n] with pad_val fill."""
    if n == 0:
        return x
    if n > 0:
        return jnp.pad(x[:, n:], ((0, 0), (0, n)), constant_values=pad_val)
    return jnp.pad(x[:, :n], ((0, 0), (-n, 0)), constant_values=pad_val)


def _morph(img: jnp.ndarray, kernel: np.ndarray, is_erode: bool) -> jnp.ndarray:
    """Sliding min/max over the footprint via a shared doubling tree of
    shifted reductions (no reduce_window)."""
    segs = _row_segments(np.asarray(kernel))
    if jnp.issubdtype(img.dtype, jnp.integer):
        pad_val = 255 if is_erode else 0
    else:
        pad_val = jnp.inf if is_erode else -jnp.inf
    reducer = jnp.minimum if is_erode else jnp.maximum
    x = img

    widths = {}
    for dy, dxl, dxr in segs:
        widths.setdefault((dxl, dxr), []).append(dy)
    max_len = max(dxr - dxl + 1 for (dxl, dxr) in widths)
    maxl = max(-dxl for (dxl, _) in widths)
    maxr = max(dxr for (_, dxr) in widths)
    W = x.shape[1]

    # pad once so border windows see neutral taps (cv2 BORDER_CONSTANT with
    # +inf/-inf), then build a doubling tree of left-aligned reductions:
    # f[k][:, i] = reduce over xp[:, i .. i+2^k-1]
    xp = jnp.pad(x, ((0, 0), (maxl, maxr)), constant_values=pad_val)
    f = [xp]
    k = 1
    while k < max_len:
        f.append(reducer(f[-1], _shift_cols(f[-1], k, pad_val)))
        k *= 2

    def left_aligned(length):
        if length == 1:
            return f[0]
        m = (length - 1).bit_length() - 1  # largest power of two <= length
        if (1 << m) > length:
            m -= 1
        return reducer(f[m], _shift_cols(f[m], length - (1 << m), pad_val))

    out = None
    for (dxl, dxr), dys in widths.items():
        g = left_aligned(dxr - dxl + 1)
        row_red = g[:, maxl + dxl : maxl + dxl + W]
        for dy in dys:
            if dy > 0:
                shifted = jnp.pad(
                    row_red[dy:], ((0, dy), (0, 0)), constant_values=pad_val
                )
            elif dy < 0:
                shifted = jnp.pad(
                    row_red[:dy], ((-dy, 0), (0, 0)), constant_values=pad_val
                )
            else:
                shifted = row_red
            out = shifted if out is None else reducer(out, shifted)
    return out


def erode(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """cv::erode parity (min filter over the kernel footprint)."""
    return _morph(img, kernel, True)


def dilate(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """cv::dilate parity (max filter over the kernel footprint)."""
    return _morph(img, kernel, False)


def morph_open_close(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Opening then closing: erode->dilate->dilate->erode (mf-sw.cpp:19-28)."""
    x = erode(img, kernel)
    x = dilate(x, kernel)
    x = dilate(x, kernel)
    x = erode(x, kernel)
    return x
