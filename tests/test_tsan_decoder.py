"""ThreadSanitizer run of the native decode thread pool (SURVEY.md §5.2).

The reference has no concurrency to race (single thread); our one
concurrent native component is the batch decode pool
(native/rtdm_jpeg.cpp). This builds the `-fsanitize=thread` flavor of the
library and drives a mixed valid/corrupt batch through it in a subprocess
(the TSAN runtime must be LD_PRELOADed before Python starts -- dlopen into
a vanilla interpreter fails on static TLS), then asserts TSAN reported no
races (a report makes the process exit nonzero and print
"WARNING: ThreadSanitizer").
"""

import ctypes.util
import os
import subprocess
import sys

import pytest

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
TSAN_LIB = os.path.join(NATIVE_DIR, "librtdm_native_tsan.so")

_DRIVER = r"""
import ctypes, sys
import numpy as np
from io import BytesIO
from PIL import Image

lib = ctypes.CDLL(sys.argv[1])
lib.rtdm_jpeg_decode_batch.restype = None

rng = np.random.default_rng(0)
frames = []
for s in range(16):
    img = Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    b = BytesIO()
    img.save(b, "JPEG", quality=95)
    frames.append(b.getvalue())
frames[3] = b"\xff\xd8corrupt"          # error path on one worker
frames[11] = frames[11][: len(frames[11]) // 2]  # truncated stream

n = len(frames)
out = np.empty((n, 48, 64, 3), np.uint8)
status = (ctypes.c_int * n)()
datas = (ctypes.c_char_p * n)(*frames)
lens = (ctypes.c_ulong * n)(*[len(f) for f in frames])
for _ in range(4):  # several pool launches: create/join threads repeatedly
    lib.rtdm_jpeg_decode_batch(
        datas, lens, n, 64, 48,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), status, 4,
    )
assert status[3] != 0
assert all(status[i] == 0 for i in range(n) if i not in (3, 11)), list(status)
print("tsan-driver-ok")
"""


def _find_libtsan():
    name = ctypes.util.find_library("tsan")
    if name is None:
        return None
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/usr/lib"):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return name  # bare soname: the loader can resolve it


@pytest.mark.skipif(_find_libtsan() is None, reason="libtsan not installed")
def test_decode_pool_race_free_under_tsan():
    from rt_depth_map.decode.native import build_locked

    try:
        build_locked("tsan")  # file-locked: xdist workers may build too
    except (subprocess.CalledProcessError, OSError) as e:
        pytest.skip(f"tsan build failed: {getattr(e, 'stderr', e)}"[:400])
    env = dict(os.environ, LD_PRELOAD=_find_libtsan())
    env["TSAN_OPTIONS"] = "halt_on_error=0 exitcode=66"
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, TSAN_LIB],
        capture_output=True,
        text=True,
        env=env,
        timeout=120,
    )
    blob = proc.stdout + proc.stderr
    assert "WARNING: ThreadSanitizer" not in blob, blob[-2000:]
    assert proc.returncode == 0, blob[-2000:]
    assert "tsan-driver-ok" in proc.stdout
