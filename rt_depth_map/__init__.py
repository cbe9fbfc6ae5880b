"""rt_depth_map — a real-time stereo depth engine on JAX.

A from-scratch re-creation of the capability surface of the reference
C++/OpenCV pipeline (wafgo/rt-depth-map: stereo capture -> MJPEG decode ->
rectify -> HSV object detection -> block/SGM matching -> 3D reprojection ->
per-object depth), re-architected for an accelerator: host-side ingest feeding
one jitted JAX device program per frame, a Pallas GPU kernel for SGM
aggregation, and image-tile sharding with halo exchange across a `jax.sharding.Mesh`.

Layer map (mirrors reference layers, see SURVEY.md section 1):
  sources/   -- L1a stream capture   (reference: stream/, V4L2)
  decode/    -- L1b decoders         (reference: decoder/, libjpeg)
  matchers/  -- L1c stereo matchers  (reference: stereo-matcher/, cv::StereoBM/SGBM)
  ops/       -- device compute: all pipeline stages as JAX/Pallas ops
  pipeline/  -- L2 orchestrator      (reference: estimator.cpp)
  cli.py     -- L3 app entry         (reference: main.cpp)
  calib/     -- calibration math     (reference: main.cpp:53-98 + OpenCV calib3d)
  parallel/  -- mesh/sharding/halo exchange (no reference analog; SURVEY.md section 2.10)
"""

__version__ = "0.1.0"

from rt_depth_map.config import EngineConfig, MatcherConfig  # noqa: F401
