"""Golden (slow, numpy) reference implementations of the matcher semantics.

These pin down the exact OpenCV behaviors the reference delegates to
(SURVEY.md section 2.9) in readable numpy, validated 1:1 against cv2 in
tests. The fast JAX/Pallas matchers are then tested for exact equality with
these goldens, which keeps cv2 out of the production dependency chain.
"""

from rt_depth_map.golden.bm import golden_stereo_bm  # noqa: F401
from rt_depth_map.golden.postproc import (  # noqa: F401
    golden_filter_speckles,
    golden_validate_disparity,
)
