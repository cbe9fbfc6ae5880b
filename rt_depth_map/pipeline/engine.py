"""The Engine: host frame loop + one jitted device program per frame.

Re-creates Estimator::run() (reference estimator.cpp:10-83). Host side:
grab -> MJPEG decode (stale-frame reuse on corrupt input, decoder parity) ->
H2D. Device side, fused into a single jit-compiled program (the
accelerator equivalent of steps 4-15 of the hot loop, SURVEY.md section 3.2):

  gray conversion x2 -> rectification remap x3 + ROI crop -> HSV threshold ->
  morphological open/close -> connected-component object boxes -> matcher ROI
  -> BM/SGM disparity -> /16 -> Q reprojection -> per-box masked depth means.

Dynamic per-frame state (HSV thresholds, min object size) enters as traced
scalars so the adjustable-trackbar semantics (estimator.cpp:294-304) never
recompile. The rectification maps are compile-time constants baked into the
program (SURVEY.md section 3.4).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from rt_depth_map.calib import RectificationResult
from rt_depth_map.config import EngineConfig
from rt_depth_map.decode import MJPEGDecoder
from rt_depth_map.ops import (
    ellipse_kernel,
    in_range,
    morph_open_close,
    remap_bilinear,
    rgb_to_gray,
    rgb_to_hsv,
)
from rt_depth_map.ops.bm import stereo_bm
from rt_depth_map.ops.detect import detect_objects, matching_region
from rt_depth_map.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)
from rt_depth_map.ops.sgbm import stereo_sgbm
from rt_depth_map.pipeline.stats import ExecTimeStats
from rt_depth_map.sources import make_source
from rt_depth_map.sources.base import StereoSource

MORPH_DX = MORPH_DY = 10  # reference mf-sw.h:11-12 structuring element


@dataclasses.dataclass
class FrameResult:
    """Outputs of one frame (host numpy)."""

    disparity: np.ndarray  # (Hr, Wr) int16 x16 fixed point
    boxes: np.ndarray  # (K, 5) int32 [x, y, w, h, valid], rect-crop coords
    depth_cm: np.ndarray  # (K,) float32, NaN where invalid/empty
    mean_z: np.ndarray  # (K,) float32 raw Z units
    count: np.ndarray  # (K,) int32 valid pixels per box
    mask: np.ndarray  # (Hr, Wr) uint8 filtered object mask
    rgb_rect: np.ndarray  # (Hr, Wr, 3) uint8 rectified left view
    #: WLS-refined disparity (ENABLE_POST_FILTER), None unless enabled
    filtered_disparity: Optional[np.ndarray] = None
    #: (K,) mean disparity per box (SHOW_DISPARITY_VALUE), None unless enabled
    disparity_mean: Optional[np.ndarray] = None

    @property
    def has_objects(self) -> bool:
        return bool(self.boxes[:, 4].sum() > 0)

    def labels(self):
        """(x, y, 'NNN cm') depth labels (set_label parity,
        estimator.cpp:250-259); appends ' disparity = N' when
        SHOW_DISPARITY_VALUE output is present."""
        out = []
        for i, (box, cm) in enumerate(zip(self.boxes, self.depth_cm)):
            if box[4] and np.isfinite(cm):
                txt = f"{cm:.0f} cm"
                if self.disparity_mean is not None and np.isfinite(
                    self.disparity_mean[i]
                ):
                    txt += f" disparity = {self.disparity_mean[i]:.1f}"
                out.append((int(box[0]), int(box[1]), txt))
        return out


def _identity_grid(width: int, height: int) -> np.ndarray:
    gx, gy = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    return np.stack([gx, gy], axis=-1)


def _default_q(width: int, height: int) -> np.ndarray:
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -width / 2.0
    Q[1, 3] = -height / 2.0
    Q[2, 3] = 0.9 * width
    Q[3, 2] = 1.0 / 4.8
    return Q


class Engine:
    """Pipeline orchestrator (Estimator parity) for one device."""

    def __init__(
        self,
        cfg: EngineConfig,
        rectification: Optional[RectificationResult] = None,
        source: Optional[StereoSource] = None,
        decoder: Optional[MJPEGDecoder] = None,
    ):
        self.cfg = cfg
        if cfg.debug_checks:
            jax.config.update("jax_debug_nans", True)
            jax.config.update("jax_debug_infs", True)
        self.source = source if source is not None else make_source(cfg)
        self.decoder = decoder if decoder is not None else MJPEGDecoder()
        W, H = self.source.width, self.source.height

        # Rectification constants (SURVEY.md section 3.4). A rectified source
        # keeps identity maps; calibration still contributes ROI and Q.
        if rectification is not None and not getattr(self.source, "rectified", False):
            self.map_left = rectification.map_left.astype(np.float32)
            self.map_right = rectification.map_right.astype(np.float32)
        else:
            self.map_left = self.map_right = _identity_grid(W, H)
        if rectification is not None:
            rx, ry, rw, rh = rectification.roi
            # clamp to the actual image in case calibration resolution differs
            rx, ry = max(0, min(rx, W - 1)), max(0, min(ry, H - 1))
            rw, rh = min(rw, W - rx), min(rh, H - ry)
            self.roi = (rx, ry, rw, rh)
            self.Q = np.asarray(rectification.Q, np.float64)
        else:
            self.roi = (0, 0, W, H)
            q_fn = getattr(self.source, "q_matrix", None)
            self.Q = q_fn() if q_fn is not None else _default_q(W, H)

        # resolution-aware derived values (cmdline-parser.h:80-89)
        self.num_disparities = max(16, (cfg.scaled_num_disparities(W) // 16) * 16)
        self.min_object_size = max(1, cfg.scaled_min_object_size(W, H))
        mcfg = cfg.matcher.replace(num_disparities=self.num_disparities)
        if mcfg.kind == "sgm" and mcfg.block_size == 13:
            mcfg = mcfg.replace(block_size=5)  # SGBM reference block size
        self.matcher_config = mcfg

        hsv = cfg.hsv_range()
        self.hsv_low = np.asarray(hsv.low, np.uint8)
        self.hsv_high = np.asarray(hsv.high, np.uint8)

        self.stats = ExecTimeStats(cfg.enable_execution_time_measurement)
        self._last: Tuple[Optional[np.ndarray], Optional[np.ndarray]] = (None, None)
        # source health (SURVEY.md section 5.3): transient corrupt frames
        # reuse the previous image (decoder parity), but a dead stream --
        # this many consecutive failures -- is a hard fault, fail-fast like
        # the reference's device-init exit(1) paths
        self.max_consecutive_decode_failures = 30
        self._consecutive_failures = 0
        frame_fn = self._build_frame_fn()
        # Donated frame buffers (the reference's device-owned zero-copy
        # buffer design, include/filter/filter.h:13-37 + estimator.cpp:
        # 141-142): each dispatch hands its input buffers back to XLA for
        # output reuse instead of allocating fresh planes per frame.
        # OPT-IN (RTDM_DONATE=1): donation forbids re-dispatching
        # persistent device-resident rings -- the framework's actual
        # device-owned-buffer mode (run_preloaded) -- without a d2d copy
        # per frame, while the allocator already recycles the per-frame
        # planes. The durable zero-copy design is the resident ring;
        # donation remains available for allocator-constrained deployments.
        self._donate = os.environ.get("RTDM_DONATE", "") not in ("", "0")
        donate = (0, 1) if self._donate else ()
        if self._donate:
            # outputs rarely byte-match BOTH uint8 eye buffers; partial
            # aliasing is the expected steady state, not a user error
            import warnings

            warnings.filterwarnings(
                "ignore", message="Some donated buffers were not usable"
            )
        self._step = jax.jit(frame_fn, donate_argnums=donate)
        self.__step_batch = None
        self._frame_fn = frame_fn
        # Multi-stream batching (BASELINE.md row 4) execution mode:
        #   * "pipelined" (default): the B streams stay INDEPENDENT -- B
        #     async dispatches of the single-frame program per step_batch.
        #     The chip executes them back-to-back with zero host gaps
        #     (JAX async dispatch), so multi-stream throughput == the
        #     single-stream rate and per-frame latency stays the b1
        #     latency; it also reuses the b1 executable (no extra
        #     compile). This is the production mode: nothing about 4
        #     independent camera rigs requires welding their tensors
        #     together.
        #   * "fused": ONE jitted B-frame program -- batched pre/post +
        #     the per-frame matchers (stereo_sgbm_batch).
        #   * "unrolled": per-frame pre/post unrolled over the batch.
        self.batch_mode = os.environ.get("RTDM_BATCH_MODE", "pipelined")
        self._frames_done = 0

    @property
    def _step_batch(self):
        """Lazily-built fused B-frame jit (compiles on first call)."""
        if self.cfg.batch <= 1:
            return None
        if self.__step_batch is None:
            if (self.batch_mode != "unrolled"
                    and os.environ.get("RTDM_NO_BATCH_PREPOST", "")
                    in ("", "0")):
                batch_fn = self._build_batch_frame_fn()
            else:
                batch_fn = self._build_unrolled_batch_fn(self._frame_fn)
            donate = (0, 1) if self._donate else ()
            self.__step_batch = jax.jit(batch_fn, donate_argnums=donate)
        return self.__step_batch

    def dispatch_batch(self, lefts, rights):
        """Async-dispatch B independent single-frame programs (pipelined
        multi-stream mode); returns the B device output trees WITHOUT
        waiting. lefts/rights: (B, H, W, 3) arrays (device or host)."""
        assert len(lefts) == self.cfg.batch == len(rights), (
            len(lefts), self.cfg.batch)
        hsv_lo = jnp.asarray(self.hsv_low)
        hsv_hi = jnp.asarray(self.hsv_high)
        msize = jnp.int32(self.min_object_size)
        outs = []
        for b in range(self.cfg.batch):
            outs.append(self._step(
                jnp.asarray(lefts[b]), jnp.asarray(rights[b]),
                hsv_lo, hsv_hi, msize,
            ))
        return outs

    def _build_unrolled_batch_fn(self, frame_fn) -> Callable:
        """Per-frame pre/post unrolled over the static batch, batched
        matcher for SGM."""
        B = self.cfg.batch

        def _stack_trees(items):
            return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *items)

        if self.matcher_config.kind == "sgm":
            from rt_depth_map.ops.sgbm import stereo_sgbm_batch

            mcfg_b = self.matcher_config

            def batch_fn(lefts, rights, hsv_low, hsv_high, min_size):
                pres = [
                    frame_fn.pre_fn(lefts[i], rights[i], hsv_low,
                                    hsv_high, min_size)
                    for i in range(B)
                ]
                lrects = jnp.stack([p[0] for p in pres])
                rrects = jnp.stack([p[1] for p in pres])
                disps = stereo_sgbm_batch(lrects, rrects, mcfg_b)
                return _stack_trees([
                    frame_fn.post_fn(pres[i][0], pres[i][1], pres[i][2],
                                     pres[i][3], pres[i][4], disps[i])
                    for i in range(B)
                ])
        else:
            def batch_fn(lefts, rights, hsv_low, hsv_high, min_size):
                return _stack_trees([
                    frame_fn(lefts[i], rights[i], hsv_low, hsv_high,
                             min_size)
                    for i in range(B)
                ])

        return batch_fn

    def _build_batch_frame_fn(self) -> Callable:
        """Fully-batched B-frame device program (bit-identical per frame to
        _build_frame_fn's single-frame program).

        Pre stage: the B frames are ROW-STACKED into one (B*H, W) image and
        rectified by ONE remap whose grid was built for the stacked
        source (each output row's source y is offset by its frame's b*H, so
        frame b only ever samples frame b -- exact); HSV/inRange run on the
        stacked rows, morphology/detection vmap/loop per frame (their
        vertical taps must not cross frame borders). Post stage: vmapped
        reprojection + depth stats. Matcher: per-frame SGM or BM."""
        cfg = self.cfg
        B = cfg.batch
        mcfg = self.matcher_config
        rx, ry, rw, rh = self.roi
        H, W = self.source.height, self.source.width
        Q = jnp.asarray(self.Q, jnp.float32)
        kernel = ellipse_kernel(MORPH_DX, MORPH_DY)

        np_l = self.map_left[ry : ry + rh, rx : rx + rw]
        np_r = self.map_right[ry : ry + rh, rx : rx + rw]
        # The stacked source gets ONE zero guard row after each frame
        # (height Hs = H + 1 per frame): bilinear windows that straddle a
        # frame's top/bottom edge (iy == -1 or H-1) then tap the guard row
        # exactly like the single-frame path taps the constant-zero border,
        # instead of bleeding into the adjacent frame's edge rows. Windows
        # FULLY outside a frame's extent are redirected to a far-out
        # sentinel so the remap's any_valid zeroes them per frame (the
        # stacked extent check alone would accept them).
        Hs = H + 1
        off = (np.arange(B, dtype=np.float32) * Hs)[:, None, None]

        def stackmap(m):
            mb = np.broadcast_to(m, (B,) + m.shape).copy()
            # replicate remap_bilinear's fixed-point quantization to find
            # per-frame fully-invalid windows (its any_valid test); their
            # coords are CLAMPED into the frame and zeroed via the
            # validity mask
            ix = np.floor(mb[..., 0])
            iy = np.floor(mb[..., 1])
            ix = ix + (np.round((mb[..., 0] - ix) * 32.0).astype(np.int64) >> 5)
            iy = iy + (np.round((mb[..., 1] - iy) * 32.0).astype(np.int64) >> 5)
            invalid = (ix < -1) | (ix > W - 1) | (iy < -1) | (iy > H - 1)
            # only invalid entries move (valid partial windows at the
            # frame's top/left edge legitimately sit in [-1, 0))
            mb[..., 0] = np.where(invalid, np.clip(mb[..., 0], 0.0, W - 1),
                                  mb[..., 0])
            mb[..., 1] = np.where(invalid, np.clip(mb[..., 1], 0.0, H - 1),
                                  mb[..., 1])
            mb[..., 1] += off  # sample frame b's rows of the stacked source
            return (mb.reshape(B * rh, rw, 2),
                    (~invalid).reshape(B * rh, rw))

        (np_lb, val_lb), (np_rb, val_rb) = stackmap(np_l), stackmap(np_r)
        grid_lb = jnp.asarray(np_lb)
        grid_rb = jnp.asarray(np_rb)
        vmask_lb = jnp.asarray(val_lb)
        vmask_rb = jnp.asarray(val_rb)

        def pre_fn_b(lefts, rights, hsv_low, hsv_high, min_size):
            # zero guard row between stacked frames (see stackmap note)
            lst = jnp.pad(lefts, ((0, 0), (0, 1), (0, 0), (0, 0))
                          ).reshape(B * Hs, W, 3)
            rst = jnp.pad(rights, ((0, 0), (0, 1), (0, 0), (0, 0))
                          ).reshape(B * Hs, W, 3)
            lg = rgb_to_gray(lst)
            rg = rgb_to_gray(rst)
            lstack = jnp.concatenate([lg[..., None], lst], axis=-1)
            lrect4 = remap_bilinear(lstack, grid_lb, valid=vmask_lb)
            rrect = remap_bilinear(rg, grid_rb, valid=vmask_rb)
            lrect = lrect4[..., 0]
            rgbr = lrect4[..., 1:]
            hsv = rgb_to_hsv(rgbr)
            mask = in_range(hsv, hsv_low, hsv_high)
            filt = jax.vmap(lambda m: morph_open_close(m, kernel))(
                mask.reshape(B, rh, rw)
            )
            boxes = jnp.stack([
                detect_objects(filt[i], min_size, cfg.max_objects)
                for i in range(B)
            ])
            mrois = [matching_region(boxes[i]) for i in range(B)]
            return (
                lrect.reshape(B, rh, rw),
                rrect.reshape(B, rh, rw),
                rgbr.reshape(B, rh, rw, 3),
                filt,
                boxes,
                mrois,
            )

        def post_fn_b(lrects, rrects, rgbrs, filts, boxes, disps):
            filtered = None
            if cfg.enable_post_filter:
                from rt_depth_map.ops.wls import (
                    right_matcher_config,
                    wls_filter,
                )

                rcfg = right_matcher_config(mcfg)
                if mcfg.kind == "sgm":
                    from rt_depth_map.ops.sgbm import stereo_sgbm_batch

                    disps_r = stereo_sgbm_batch(rrects, lrects, rcfg)
                else:
                    disps_r = jnp.stack([
                        stereo_bm(rrects[i], lrects[i], rcfg)
                        for i in range(B)
                    ])
                filtered = jnp.stack([
                    wls_filter(disps[i], disps_r[i], lrects[i], mcfg)[0]
                    for i in range(B)
                ])

            dint = disparity_fixed_to_float(disps)
            xyz = jax.vmap(
                lambda d: reproject_to_3d(d, Q, mcfg.min_disparity, True)
            )(dint)
            unit = cfg.calibration_unit_mm
            disp_mean = None
            if cfg.show_disparity_value:
                depth_cm, mean_z, count, disp_mean = jax.vmap(
                    lambda x, f, b, e: calc_depth(x, f, b, unit, extra=e)
                )(xyz, filts, boxes, dint)
            else:
                depth_cm, mean_z, count = jax.vmap(
                    lambda x, f, b: calc_depth(x, f, b, unit)
                )(xyz, filts, boxes)
            out = dict(
                disparity=disps,
                boxes=boxes,
                depth_cm=depth_cm,
                mean_z=mean_z,
                count=count,
                mask=filts,
                rgb_rect=rgbrs,
            )
            if filtered is not None:
                out["filtered_disparity"] = filtered
            if disp_mean is not None:
                out["disparity_mean"] = disp_mean
            return out

        if mcfg.kind == "sgm":
            from rt_depth_map.ops.sgbm import stereo_sgbm_batch

        def batch_fn(lefts, rights, hsv_low, hsv_high, min_size):
            lrects, rrects, rgbrs, filts, boxes, mrois = pre_fn_b(
                lefts, rights, hsv_low, hsv_high, min_size
            )
            if mcfg.kind == "sgm":
                disps = stereo_sgbm_batch(lrects, rrects, mcfg)
            else:
                disps = jnp.stack([
                    stereo_bm(lrects[i], rrects[i], mcfg, roi1=mrois[i],
                              roi2=None)
                    for i in range(B)
                ])
            return post_fn_b(lrects, rrects, rgbrs, filts, boxes, disps)

        return batch_fn

    # -- device program ----------------------------------------------------
    def _build_frame_fn(self) -> Callable:
        cfg = self.cfg
        mcfg = self.matcher_config
        rx, ry, rw, rh = self.roi
        grid_l = jnp.asarray(self.map_left)
        grid_r = jnp.asarray(self.map_right)
        Q = jnp.asarray(self.Q, jnp.float32)
        kernel = ellipse_kernel(MORPH_DX, MORPH_DY)

        # Only the ROI rows/cols of the remap grids are ever consumed
        # (estimator.cpp:32-38 remaps then crops); slicing the grids instead
        # gathers ~2.4x fewer pixels at the 720p calibration ROI and is
        # bit-identical to remap-then-crop.
        grid_l_roi = grid_l[ry : ry + rh, rx : rx + rw]
        grid_r_roi = grid_r[ry : ry + rh, rx : rx + rw]

        def pre_fn(left_rgb, right_rgb, hsv_low, hsv_high, min_size):
            """Rectification + detection: everything before the matcher."""
            lg = rgb_to_gray(left_rgb)
            rg = rgb_to_gray(right_rgb)
            # rectify + ROI crop (estimator.cpp:32-38). The left gray and
            # left RGB remaps share one map, so they ride ONE gather as a
            # packed 4-channel image (per-channel results are bit-identical
            # to separate remaps).
            lstack = jnp.concatenate([lg[..., None], left_rgb], axis=-1)
            lrect4 = remap_bilinear(lstack, grid_l_roi)
            lrect = lrect4[..., 0]
            rgbr = lrect4[..., 1:]
            rrect = remap_bilinear(rg, grid_r_roi)

            # detection path (estimator.cpp:41-56)
            hsv = rgb_to_hsv(rgbr)
            mask = in_range(hsv, hsv_low, hsv_high)
            filt = morph_open_close(mask, kernel)
            boxes = detect_objects(filt, min_size, cfg.max_objects)
            mroi = matching_region(boxes)
            return lrect, rrect, rgbr, filt, boxes, mroi

        def match_fn(lrect, rrect, mroi):
            # matcher (estimator.cpp:57; ROI2 intentionally unset --
            # the reference's /*FIXME*/ at estimator.cpp:55)
            if mcfg.kind == "sgm":
                return stereo_sgbm(lrect, rrect, mcfg)
            return stereo_bm(lrect, rrect, mcfg, roi1=mroi, roi2=None)

        def post_fn(lrect, rrect, rgbr, filt, boxes, disp):
            filtered = None
            if cfg.enable_post_filter:
                # ENABLE_POST_FILTER (estimator.cpp:59-71): right-view
                # matcher + confidence-weighted WLS refinement
                from rt_depth_map.ops.wls import (
                    right_matcher_config,
                    wls_filter,
                )

                rcfg = right_matcher_config(mcfg)
                if mcfg.kind == "sgm":
                    disp_r = stereo_sgbm(rrect, lrect, rcfg)
                else:
                    disp_r = stereo_bm(rrect, lrect, rcfg)
                filtered, _ = wls_filter(disp, disp_r, lrect, mcfg)

            # depth (estimator.cpp:75-77)
            dint = disparity_fixed_to_float(disp)
            xyz = reproject_to_3d(dint, Q, mcfg.min_disparity, True)
            disp_mean = None
            if cfg.show_disparity_value:
                # SHOW_DISPARITY_VALUE (estimator.h:33): mean disparity per
                # box over the same accepted pixels as the depth mean
                depth_cm, mean_z, count, disp_mean = calc_depth(
                    xyz, filt, boxes, cfg.calibration_unit_mm, extra=dint
                )
            else:
                depth_cm, mean_z, count = calc_depth(
                    xyz, filt, boxes, cfg.calibration_unit_mm
                )
            out = dict(
                disparity=disp,
                boxes=boxes,
                depth_cm=depth_cm,
                mean_z=mean_z,
                count=count,
                mask=filt,
                rgb_rect=rgbr,
            )
            if filtered is not None:
                out["filtered_disparity"] = filtered
            if disp_mean is not None:
                out["disparity_mean"] = disp_mean
            return out

        def frame_fn(left_rgb, right_rgb, hsv_low, hsv_high, min_size):
            lrect, rrect, rgbr, filt, boxes, mroi = pre_fn(
                left_rgb, right_rgb, hsv_low, hsv_high, min_size
            )
            disp = match_fn(lrect, rrect, mroi)
            return post_fn(lrect, rrect, rgbr, filt, boxes, disp)

        frame_fn.pre_fn = pre_fn
        frame_fn.post_fn = post_fn
        return frame_fn

    # -- host loop ---------------------------------------------------------
    def _decode_eye(self, frame, slot: int) -> Optional[np.ndarray]:
        if frame.encoding == "raw":
            return frame.array
        arr = self.decoder.decode(frame.data, self.source.width, self.source.height)
        if arr is None:
            # corrupt frame: keep previous image (mjpeg-decoder-sw.cpp:108-110)
            return self._last[slot]
        return arr

    def process_pair(self, left_rgb: np.ndarray, right_rgb: np.ndarray) -> FrameResult:
        """Run the device program on one decoded RGB pair."""
        out = self._step(
            jnp.asarray(left_rgb),
            jnp.asarray(right_rgb),
            jnp.asarray(self.hsv_low),
            jnp.asarray(self.hsv_high),
            jnp.int32(self.min_object_size),
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        return FrameResult(**out)

    def set_hsv_thresholds(self, low, high) -> None:
        """Runtime HSV threshold adjustment (the reference's -a trackbar UI,
        estimator.cpp:294-304). Traced as dynamic scalars -- no recompile."""
        self.hsv_low = np.asarray(low, np.uint8)
        self.hsv_high = np.asarray(high, np.uint8)

    def set_min_object_size(self, min_size: int) -> None:
        self.min_object_size = int(min_size)

    def process_batch(self, lefts: np.ndarray, rights: np.ndarray):
        """Run the device program on a (B, H, W, 3) batch of decoded pairs
        (multi-stream batching, BASELINE.md); returns a list of FrameResult."""
        assert self.cfg.batch > 1, "EngineConfig.batch must be > 1"
        B = lefts.shape[0]
        if self.batch_mode == "pipelined":
            outs = self.dispatch_batch(lefts, rights)
            outs = jax.tree_util.tree_map(np.asarray, outs)
            return [FrameResult(**o) for o in outs]
        out = self._step_batch(
            jnp.asarray(lefts),
            jnp.asarray(rights),
            jnp.asarray(self.hsv_low),
            jnp.asarray(self.hsv_high),
            jnp.int32(self.min_object_size),
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        return [
            FrameResult(**{k: v[i] for k, v in out.items()}) for i in range(B)
        ]

    def step_batch(self):
        """One batched iteration: grab cfg.batch pairs (from a
        MultiStreamSource's rigs, or consecutive frames of a single source),
        decode, and run them in one device dispatch."""
        B = self.cfg.batch
        st = self.stats
        st.start_iteration()
        with st.measure("grabOneFrame"):
            if hasattr(self.source, "grab_batch"):
                pairs = self.source.grab_batch()
            else:
                pairs = [self.source.grab() for _ in range(B)]
        with st.measure("decode"):
            decoded = []
            for lf, rf in pairs:
                left = self._decode_eye(lf, 0)
                right = self._decode_eye(rf, 1)
                if left is not None and right is not None:
                    decoded.append((left, right))
        if len(decoded) < B:
            return None
        self._last = decoded[-1]
        with st.measure("h2d+device+d2h"):
            results = self.process_batch(
                np.stack([d[0] for d in decoded]),
                np.stack([d[1] for d in decoded]),
            )
        self._frames_done += B
        return results

    def step(self) -> Optional[FrameResult]:
        """One iteration of the frame loop (estimator.cpp:18-82)."""
        st = self.stats
        st.start_iteration()
        pair = self._grab_decode()
        if pair is None:
            return None  # nothing decoded yet at all
        with st.measure("h2d+device+d2h"):
            result = self.process_pair(*pair)
        self._frames_done += 1
        return result

    def _dispatch(self, left: np.ndarray, right: np.ndarray):
        """Enqueue the device program for one decoded pair WITHOUT waiting
        (JAX dispatch is async); returns the device-array output tree."""
        return self._step(
            jnp.asarray(left),
            jnp.asarray(right),
            jnp.asarray(self.hsv_low),
            jnp.asarray(self.hsv_high),
            jnp.int32(self.min_object_size),
        )

    def _grab_decode(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One grab+decode with the stale-frame/health bookkeeping of
        step(); returns the decoded pair or None when nothing decoded yet."""
        st = self.stats
        with st.measure("grabOneFrame"):
            lf, rf = self.source.grab()
        with st.measure("decode"):
            left = self._decode_eye(lf, 0)
            right = self._decode_eye(rf, 1)
        fresh = (
            (lf.encoding == "raw" or left is not self._last[0])
            and (rf.encoding == "raw" or right is not self._last[1])
        )
        if not fresh:
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.max_consecutive_decode_failures:
                raise RuntimeError(
                    f"stream unhealthy: {self._consecutive_failures} "
                    f"consecutive decode failures"
                )
        else:
            self._consecutive_failures = 0
        if left is None or right is None:
            return None
        self._last = (left, right)
        return left, right

    def run(
        self,
        frames: Optional[int] = None,
        on_frame: Optional[Callable[[int, FrameResult], None]] = None,
        print_stats_on_sigint: bool = True,
        pipeline_depth: int = 2,
        prefetch: bool = True,
    ) -> int:
        """Blocking frame loop; frames=None runs until SIGINT (while(1)
        parity). Returns the number of frames processed.

        The loop is PIPELINED (SURVEY.md section 2.10 PP row): frame N+1 is
        grabbed/decoded/dispatched while frame N still executes on device --
        the analog of the reference's device-owned buffers + fire-and-
        forget accelerator start (estimator.cpp:141-142,
        generic-hw-filter-ip.cpp:126-136). `pipeline_depth` bounds the
        in-flight device programs; results are only pulled to host when a
        consumer exists (`on_frame`), otherwise a small per-frame field is
        fetched every few frames as backpressure so the dispatch queue
        cannot run unboundedly ahead.

        prefetch=True additionally moves grab+decode OFF the dispatch
        thread: a background producer keeps a small queue of decoded pairs
        (bounded, 2-deep beyond the dispatch depth) so camera/decoder
        latency overlaps device execution instead of serializing in front
        of it (SURVEY.md section 7 hard part 6 -- host ingest at rate).
        The reference's single-buffered
        V4L2 capture blocks its whole loop per frame
        (v4l2-stream-stereo-device.cpp:112-133); a real deployment wants
        the queue."""
        stop = {"flag": False}

        def handler(signum, frame):
            # SIGINT -> stop -> stats report (main.cpp:100-106 parity);
            # the report itself prints after the loop notes wall-clock
            # throughput, so the SIGINT report carries the pipelined fps
            stop["flag"] = True

        old = None
        if print_stats_on_sigint:
            try:
                old = signal.signal(signal.SIGINT, handler)
            except ValueError:
                old = None  # non-main thread

        from collections import deque

        depth = max(1, pipeline_depth)
        pending = deque()  # (index, device output tree)
        sync_every = 8
        st = self.stats
        # result pulls overlap the next frames' dispatch/execution; the
        # report must not count them into the frame period
        st.mark_overlapped("d2h")

        def retire(idx, out):
            if on_frame is not None:
                with st.measure("d2h"):
                    host = jax.tree_util.tree_map(np.asarray, out)
                if on_frame(idx, FrameResult(**host)) is False:
                    stop["flag"] = True  # consumer requested stop (e.g. ESC)
            elif idx % sync_every == 0:
                # backpressure only: one tiny field, not the frame
                with st.measure("d2h"):
                    np.asarray(out["count"])

        producer = None
        pstop = None
        q = None
        perr: list = []
        if prefetch:
            import queue as _queue
            import threading

            # grab/decode run in the producer; their wall time overlaps
            # device execution and must not count into the frame period
            st.mark_overlapped("grabOneFrame")
            st.mark_overlapped("decode")
            q = _queue.Queue(maxsize=depth + 2)
            pstop = threading.Event()

            def _produce():
                # stop at the requested frame count: a finite source must
                # not be read past what the loop will consume (a loop=False
                # FileSequenceSource would hit StopIteration on the
                # read-ahead and poison the run)
                produced = 0
                while not pstop.is_set() and (frames is None
                                              or produced < frames):
                    try:
                        pair = self._grab_decode()
                    except Exception as e:  # dead stream: fail the loop
                        perr.append(e)
                        return
                    if pair is None:
                        continue
                    while not pstop.is_set():
                        try:
                            q.put(pair, timeout=0.1)
                            produced += 1
                            break
                        except _queue.Full:
                            continue

            producer = threading.Thread(target=_produce, daemon=True,
                                        name="rtdm-ingest")
            producer.start()

        def next_pair():
            if not prefetch:
                return self._grab_decode()
            import queue as _queue

            while True:
                if perr:
                    # drain decoded pairs still queued before surfacing the
                    # producer's failure (a finite source's StopIteration
                    # must not abort frames that already decoded)
                    try:
                        return q.get_nowait()
                    except _queue.Empty:
                        raise perr[0] from None
                if stop["flag"]:
                    return None
                try:
                    with st.measure("grab (queue wait)"):
                        return q.get(timeout=0.1)
                except _queue.Empty:
                    continue

        try:
            i = 0
            done0 = self._frames_done
            t_loop0 = time.perf_counter()
            while frames is None or i < frames:
                if stop["flag"]:
                    break
                st.start_iteration()
                pair = next_pair()
                if pair is not None:
                    with st.measure("dispatch"):
                        pending.append((i, self._dispatch(*pair)))
                    self._frames_done += 1
                while len(pending) >= depth:
                    retire(*pending.popleft())
                i += 1
            while pending:
                retire(*pending.popleft())
            st.note_wall(self._frames_done - done0,
                         time.perf_counter() - t_loop0)
            if stop["flag"] and print_stats_on_sigint:
                print(st.report(), file=sys.stderr)
            return i
        finally:
            if pstop is not None:
                pstop.set()
            if producer is not None:
                producer.join(timeout=2.0)
            if old is not None:
                signal.signal(signal.SIGINT, old)

    def run_preloaded(self, frames: int, n_inputs: int = 6,
                      pipeline_depth: int = 3) -> int:
        """Sustained-throughput loop over DEVICE-RESIDENT inputs:
        n_inputs distinct pairs are grabbed, decoded and uploaded ONCE,
        then cycled through the device program for `frames` dispatches.

        This is the deployment-realistic operating mode for zero-copy
        camera ingest (the reference's device-owned buffers,
        include/filter/filter.h:13-37 design): throughput is bounded by
        the device program, not the host->device link."""
        if frames <= 0:
            return 0
        st = self.stats
        pairs = []
        with st.measure("preload (grab+decode+h2d)"):
            guard = 0
            while len(pairs) < n_inputs and guard < 10 * n_inputs:
                guard += 1
                pair = self._grab_decode()
                if pair is None:
                    continue
                pairs.append((jnp.asarray(pair[0]), jnp.asarray(pair[1])))
            if not pairs:
                raise RuntimeError(
                    "run_preloaded: no frame pair could be grabbed+decoded "
                    f"in {guard} attempts (source unhealthy?)"
                )
            jax.block_until_ready(pairs[-1])
        hsv_lo = jnp.asarray(self.hsv_low)
        hsv_hi = jnp.asarray(self.hsv_high)
        msize = jnp.int32(self.min_object_size)

        from collections import deque

        st.mark_overlapped("d2h")
        pending = deque()
        done0 = self._frames_done
        t0 = time.perf_counter()
        # The production step donates its frame buffers, which would
        # consume the persistent ring on first use; rather than a d2d copy
        # per dispatch, the preloaded loop runs its own UNDONATED
        # executable (lazy; amortized by the persistent compilation cache).
        step = self._step
        if self._donate:
            if getattr(self, "_step_nodonate", None) is None:
                self._step_nodonate = jax.jit(self._frame_fn)
            step = self._step_nodonate
        for i in range(frames):
            st.start_iteration()
            l, r = pairs[i % len(pairs)]
            with st.measure("dispatch"):
                pending.append(step(l, r, hsv_lo, hsv_hi, msize))
            self._frames_done += 1
            while len(pending) >= max(1, pipeline_depth):
                out = pending.popleft()
                if i % 8 == 0:  # backpressure only
                    with st.measure("d2h"):
                        np.asarray(out["count"])
        while pending:
            out = pending.popleft()
        with st.measure("d2h"):
            np.asarray(out["count"])  # final completion barrier
        st.note_wall(self._frames_done - done0, time.perf_counter() - t0)
        return frames

    def warmup(self) -> float:
        """Compile the device program; returns compile seconds."""
        W, H = self.source.width, self.source.height
        z = np.zeros((H, W, 3), np.uint8)
        t0 = time.perf_counter()
        jax.block_until_ready(self.process_pair(z, z).disparity)
        return time.perf_counter() - t0

    def close(self) -> None:
        self.source.close()
