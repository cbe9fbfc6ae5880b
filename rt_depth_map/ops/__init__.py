"""Device-side pipeline ops (JAX / Pallas).

Each op re-creates an OpenCV stage the reference delegates to
(SURVEY.md section 2.9), with integer-exact uint8 semantics where the
reference's behavior depends on OpenCV's fixed-point arithmetic. All ops are
jit-safe, static-shape, and batched via vmap.
"""

from rt_depth_map.ops.color import rgb_to_gray, rgb_to_hsv, in_range  # noqa: F401
from rt_depth_map.ops.remap import remap_bilinear  # noqa: F401
from rt_depth_map.ops.morphology import (  # noqa: F401
    ellipse_kernel,
    erode,
    dilate,
    morph_open_close,
)
from rt_depth_map.ops.prefilter import xsobel_prefilter  # noqa: F401
