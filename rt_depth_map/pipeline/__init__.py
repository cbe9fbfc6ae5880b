"""L2 pipeline orchestrator (reference estimator.cpp).

The Engine owns the host frame loop: grab -> decode -> H2D -> one jitted
device program (gray/rectify/HSV/morph/detect/match/reproject/depth) -> D2H,
with per-stage timing stats (MEASURE_EXECUTION_TIME parity) and the
reference's stale-frame behavior on decode failure.
"""

from rt_depth_map.pipeline.stats import ExecTimeStats  # noqa: F401
from rt_depth_map.pipeline.engine import Engine, FrameResult  # noqa: F401
