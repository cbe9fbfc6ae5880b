"""Native C++ libjpeg decoder: build, decode, Huffman injection, batching."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.decode import native
from rt_depth_map.decode.mjpeg import MJPEGDecoder

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build failed: {native.build_error()}"
)


def jpeg_frame(seed=0, H=48, W=64, quality=95):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    rgb = cv2.GaussianBlur(rgb, (5, 5), 0)
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return rgb, buf.tobytes()


def strip_dht(buf: bytes) -> bytes:
    out = bytearray(buf[:2])
    i = 2
    while i + 4 <= len(buf):
        marker = buf[i + 1]
        if marker == 0xDA:
            out += buf[i:]
            break
        seg_len = int.from_bytes(buf[i + 2 : i + 4], "big")
        if marker != 0xC4:
            out += buf[i : i + 2 + seg_len]
        i += 2 + seg_len
    return bytes(out)


def test_native_decode_close_to_cv2():
    rgb, jpeg = jpeg_frame(0)
    ref = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    out = native.decode(jpeg, 64, 48)
    assert out is not None and out.shape == (48, 64, 3)
    # JDCT_IFAST vs cv2's decoder: small integer differences allowed
    assert np.abs(out.astype(int) - ref.astype(int)).mean() < 3.0


def test_native_decodes_huffmanless_frames():
    _, jpeg = jpeg_frame(1)
    stripped = strip_dht(jpeg)
    full = native.decode(jpeg, 64, 48)
    bare = native.decode(stripped, 64, 48)
    assert bare is not None
    np.testing.assert_array_equal(full, bare)  # same tables, same output


def test_native_corrupt_returns_none():
    assert native.decode(b"\xff\xd8garbage", 10, 10) is None
    _, jpeg = jpeg_frame(2)
    # truncated entropy data: libjpeg emits a fake EOI and completes with a
    # warning -- the reference decoder behaves identically (only error_exit
    # paths fail), so a partial image (not None) is the parity behavior
    assert native.decode(jpeg[: len(jpeg) // 2], 64, 48) is not None
    assert native.decode(jpeg, 32, 32) is None  # size mismatch


def test_native_batch_pool():
    frames, refs = [], []
    for s in range(8):
        rgb, jpeg = jpeg_frame(s)
        frames.append(jpeg)
        refs.append(native.decode(jpeg, 64, 48))
    frames[3] = b"corrupt"
    outs = native.decode_batch(frames, 64, 48, n_threads=4)
    assert outs[3] is None
    for i in (0, 1, 2, 4, 5, 6, 7):
        np.testing.assert_array_equal(outs[i], refs[i])


def test_mjpeg_decoder_auto_prefers_native():
    dec = MJPEGDecoder("auto")
    assert dec._native is not None
    _, jpeg = jpeg_frame(4)
    out = dec.decode(jpeg, 64, 48)
    assert out is not None and out.shape == (48, 64, 3)
