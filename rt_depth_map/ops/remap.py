"""Bilinear remap (the rectification gather of estimator.cpp:32-38).

cv::remap semantics with the reference's CV_16SC2 fixed-point maps: source
coordinates quantized to 1/32 px, constant-zero border, fixed-point bilinear
weights for uint8 inputs. The weight arithmetic uses 10-bit integer weights
((32-fx)*(32-fy) etc., summing to exactly 1024) instead of OpenCV's 15-bit
table; outputs match OpenCV within +/-1 LSB (tests assert that bound).

The gather is expressed as jnp.take on flattened indices, which XLA lowers to
a gather; the maps are compile-time constants of the jitted pipeline so
the index computation folds away.
"""

from __future__ import annotations

import jax.numpy as jnp


def remap_bilinear(img: jnp.ndarray, grid: jnp.ndarray,
                   valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Sample `img` at `grid` (..., 2) [x, y] source coordinates.

    img: (H, W) or (H, W, C), uint8 or float. grid: (Ho, Wo, 2) float32.
    Returns (Ho, Wo[, C]) with img.dtype. Out-of-image taps read 0
    (BORDER_CONSTANT, the cv::remap default used by the reference).

    valid: optional (Ho, Wo) bool -- entries marked False output 0 even if
    their coords fall inside `img` (frame-stacked sources whose per-frame
    extent is tighter than the stacked extent -- engine batch path).
    """
    H, W = img.shape[:2]
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    C = img.shape[-1]

    mx = grid[..., 0]
    my = grid[..., 1]
    # 1/32-px fixed point (CV_16SC2 map parity, main.cpp:95-96).
    ix = jnp.floor(mx).astype(jnp.int32)
    iy = jnp.floor(my).astype(jnp.int32)
    fx = jnp.round((mx - ix) * 32.0).astype(jnp.int32)
    fy = jnp.round((my - iy) * 32.0).astype(jnp.int32)
    # round() can push the fraction to 32; carry into the integer part.
    ix = ix + (fx >> 5)
    iy = iy + (fy >> 5)
    fx = fx & 31
    fy = fy & 31

    if img.dtype == jnp.uint8:
        # Pack each 2x2 uint8 neighborhood into one uint32 so the bilinear
        # read is a SINGLE gather instead of four. The image is
        # zero-padded by one pixel on every side,
        # so windows at ix or iy == -1 or W-1/H-1 read the constant-zero
        # border exactly like the per-tap valid masks did; windows fully
        # outside are masked to 0 afterwards.
        pad = jnp.pad(img, ((1, 1), (1, 1), (0, 0))).astype(jnp.uint32)
        P = (
            pad[:-1, :-1]
            | (pad[:-1, 1:] << 8)
            | (pad[1:, :-1] << 16)
            | (pad[1:, 1:] << 24)
        )  # (H+1, W+1, C); P[y, x] = window with top-left (y-1, x-1) of img
        Hp, Wp = H + 1, W + 1
        any_valid = (ix >= -1) & (ix <= W - 1) & (iy >= -1) & (iy <= H - 1)
        if valid is not None:
            any_valid = any_valid & valid
        lin = jnp.clip(iy + 1, 0, Hp - 1) * Wp + jnp.clip(ix + 1, 0, Wp - 1)
        packed = jnp.take(P.reshape(Hp * Wp, C), lin.reshape(-1), axis=0)
        packed = packed.reshape(lin.shape + (C,))
        p00 = (packed & 0xFF).astype(jnp.int32)
        p01 = ((packed >> 8) & 0xFF).astype(jnp.int32)
        p10 = ((packed >> 16) & 0xFF).astype(jnp.int32)
        p11 = ((packed >> 24) & 0xFF).astype(jnp.int32)
        w00 = ((32 - fx) * (32 - fy))[..., None]
        w01 = (fx * (32 - fy))[..., None]
        w10 = ((32 - fx) * fy)[..., None]
        w11 = (fx * fy)[..., None]
        acc = p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11
        out = ((acc + 512) >> 10).astype(img.dtype)
        out = jnp.where(any_valid[..., None], out, 0)
    else:
        def tap(yy, xx):
            valid = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            lin = jnp.clip(yy, 0, H - 1) * W + jnp.clip(xx, 0, W - 1)
            vals = jnp.take(img.reshape(H * W, C), lin.reshape(-1), axis=0)
            vals = vals.reshape(lin.shape + (C,))
            return jnp.where(valid[..., None], vals, 0)

        p00 = tap(iy, ix)
        p01 = tap(iy, ix + 1)
        p10 = tap(iy + 1, ix)
        p11 = tap(iy + 1, ix + 1)
        gx = (fx / 32.0)[..., None]
        gy = (fy / 32.0)[..., None]
        out = (
            p00 * (1 - gx) * (1 - gy)
            + p01 * gx * (1 - gy)
            + p10 * (1 - gx) * gy
            + p11 * gx * gy
        ).astype(img.dtype)
        if valid is not None:
            out = jnp.where(valid[..., None], out, 0)

    return out[..., 0] if squeeze else out
