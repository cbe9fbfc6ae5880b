"""Runtime coverage of the V4L2 capture path (QBUF/DQBUF/mmap protocol).

tests/test_v4l2_abi.py pins the ctypes struct ABI; this file executes the
full capture PROTOCOL against a faithful fake kernel device: open ->
QUERYCAP (capability gating) -> S_FMT -> REQBUFS -> QUERYBUF -> mmap ->
STREAMON -> per-frame QBUF-both/DQBUF-both -> STREAMOFF, with real MJPEG
bytes (including Huffman-table-stripped UVC-style frames) flowing from the
fake device buffers through MJPEGDecoder into decoded RGB.

The fake enforces kernel-side ordering rules the reference relies on
(v4l2-stream-stereo-device.cpp:13-133): DQBUF without a queued buffer is
EINVAL, S_FMT before REQBUFS, STREAMON before QBUF is accepted but DQBUF
only returns queued data, QUERYBUF supplies the mmap offset/length the
client must use verbatim.
"""

import ctypes
import errno
import types

import numpy as np
import pytest

import rt_depth_map.sources.v4l2 as v4l2
from rt_depth_map.decode import MJPEGDecoder


def _mjpeg_frames(w, h, n, strip_huffman=False, seed=0):
    cv2 = pytest.importorskip("cv2")
    from tests.test_native_decoder import strip_dht

    rng = np.random.default_rng(seed)
    frames, rgbs = [], []
    for i in range(n):
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        rgb[:, :, 0] = (i * 37) % 256  # frame-distinguishing plane
        ok, buf = cv2.imencode(".jpg", rgb[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok
        data = buf.tobytes()
        if strip_huffman:
            data = strip_dht(data)
        frames.append(data)
        rgbs.append(rgb)
    return frames, rgbs


class FakeV4L2Kernel:
    """Kernel-side state machine for N fake /dev/video* devices."""

    BUF_LEN = 1 << 20
    MMAP_OFFSET = 0x1000  # kernels hand out nonzero cookie offsets

    def __init__(self):
        self.devices = {}  # path -> per-device dict
        self.fds = {}  # fd -> device dict
        self._next_fd = 1000

    def add_device(self, path, frames, caps=None):
        self.devices[path] = dict(
            frames=list(frames), caps=caps, fmt=None, reqbufs=0,
            streaming=False, queued=False, seq=0,
            mm=bytearray(self.BUF_LEN), open=False,
        )

    # --- os.* ---
    def open(self, path, flags):
        dev = self.devices.get(path)
        if dev is None:
            raise FileNotFoundError(errno.ENOENT, path)
        fd = self._next_fd
        self._next_fd += 1
        dev["open"] = True
        self.fds[fd] = dev
        return fd

    def close(self, fd):
        self.fds.pop(fd)["open"] = False

    # --- fcntl.ioctl ---
    def ioctl(self, fd, request, arg=0):
        dev = self.fds[fd]
        if request == v4l2._VIDIOC_QUERYCAP:
            caps = dev["caps"]
            if caps is None:
                caps = (v4l2._V4L2_CAP_VIDEO_CAPTURE
                        | v4l2._V4L2_CAP_STREAMING)
            arg.capabilities = caps
            card = b"Fake UVC Stereo Eye"
            ctypes.memmove(arg.card, card, len(card))
            return 0
        if request == v4l2._VIDIOC_S_FMT:
            assert arg.type == v4l2._V4L2_BUF_TYPE_VIDEO_CAPTURE
            assert arg.fmt.pixelformat == v4l2._V4L2_PIX_FMT_MJPEG
            dev["fmt"] = (arg.fmt.width, arg.fmt.height)
            arg.fmt.sizeimage = self.BUF_LEN
            return 0
        if request == v4l2._VIDIOC_REQBUFS:
            if dev["fmt"] is None:
                raise OSError(errno.EINVAL, "REQBUFS before S_FMT")
            assert arg.memory == v4l2._V4L2_MEMORY_MMAP
            dev["reqbufs"] = arg.count
            return 0
        if request == v4l2._VIDIOC_QUERYBUF:
            if dev["reqbufs"] < 1 or arg.index >= dev["reqbufs"]:
                raise OSError(errno.EINVAL, "QUERYBUF without REQBUFS")
            arg.length = self.BUF_LEN
            arg.m.offset = self.MMAP_OFFSET
            return 0
        if request == v4l2._VIDIOC_STREAMON:
            dev["streaming"] = True
            return 0
        if request == v4l2._VIDIOC_STREAMOFF:
            dev["streaming"] = False
            dev["queued"] = False
            return 0
        if request == v4l2._VIDIOC_QBUF:
            if dev["reqbufs"] < 1:
                raise OSError(errno.EINVAL, "QBUF without buffers")
            dev["queued"] = True
            return 0
        if request == v4l2._VIDIOC_DQBUF:
            if not (dev["streaming"] and dev["queued"]):
                raise OSError(errno.EINVAL, "DQBUF without queued buffer")
            frame = dev["frames"][dev["seq"] % len(dev["frames"])]
            dev["seq"] += 1
            dev["queued"] = False
            dev["mm"][: len(frame)] = frame
            arg.bytesused = len(frame)
            arg.sequence = dev["seq"]
            return 0
        raise OSError(errno.ENOTTY, f"unknown ioctl {request:#x}")

    # --- mmap.mmap ---
    def mmap(self, fd, length, flags=None, prot=None, offset=0):
        dev = self.fds[fd]
        assert offset == self.MMAP_OFFSET, "client must use QUERYBUF offset"
        assert length == self.BUF_LEN, "client must use QUERYBUF length"
        kernel_buf = dev["mm"]

        class _MM:
            def __getitem__(self, item):
                return bytes(kernel_buf[item])

            def close(self):
                pass

        return _MM()


@pytest.fixture
def fake_kernel(monkeypatch):
    k = FakeV4L2Kernel()
    fake_os = types.SimpleNamespace(
        open=k.open, close=k.close, O_RDWR=0,
    )
    fake_fcntl = types.SimpleNamespace(ioctl=k.ioctl)
    fake_mmap = types.SimpleNamespace(
        mmap=k.mmap, MAP_SHARED=1, PROT_READ=1, PROT_WRITE=2,
    )
    monkeypatch.setattr(v4l2, "os", fake_os)
    monkeypatch.setattr(v4l2, "fcntl", fake_fcntl)
    monkeypatch.setattr(v4l2, "mmap", fake_mmap)
    return k


def test_capture_protocol_end_to_end(fake_kernel):
    """open->QUERYCAP->S_FMT->REQBUFS->QUERYBUF->mmap->STREAMON, then
    QBUF-both/DQBUF-both per frame; MJPEG bytes decode to the original
    frames in sequence order."""
    w, h = 64, 48
    lframes, lrgbs = _mjpeg_frames(w, h, 3, seed=1)
    rframes, rrgbs = _mjpeg_frames(w, h, 3, seed=2)
    fake_kernel.add_device("/dev/video1", lframes)
    fake_kernel.add_device("/dev/video0", rframes)

    src = v4l2.V4L2StereoSource("/dev/video1", "/dev/video0", w, h)
    dec = MJPEGDecoder()
    for i in range(3):
        lf, rf = src.grab()
        assert lf.encoding == "mjpeg" and rf.encoding == "mjpeg"
        assert bytes(lf.data) == lframes[i], f"frame {i} bytes mismatch"
        l_rgb = dec.decode(lf.data, w, h)
        r_rgb = dec.decode(rf.data, w, h)
        assert l_rgb is not None and l_rgb.shape == (h, w, 3)
        # frames arrive in sequence: each decode is closest to ITS original
        # (JPEG-lossy, so compare mean abs error across candidates)
        def _mae(a, b):
            return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())

        l_err = [_mae(l_rgb, c) for c in lrgbs]
        r_err = [_mae(r_rgb, c) for c in rrgbs]
        assert int(np.argmin(l_err)) == i, (i, l_err)
        assert int(np.argmin(r_err)) == i, (i, r_err)
    src.close()
    assert not fake_kernel.devices["/dev/video1"]["streaming"]
    assert not fake_kernel.devices["/dev/video0"]["open"]


def test_huffmanless_uvc_frames_decode(fake_kernel):
    """UVC cameras omit the Huffman tables (ISO 10918-1 K.3.3 defaults);
    the decoder must inject them (mjpeg-decoder-sw.cpp:15-93 parity) for
    frames captured through the V4L2 path."""
    w, h = 64, 48
    frames, rgbs = _mjpeg_frames(w, h, 2, strip_huffman=True, seed=3)
    fake_kernel.add_device("/dev/video1", frames)
    fake_kernel.add_device("/dev/video0", frames)
    src = v4l2.V4L2StereoSource("/dev/video1", "/dev/video0", w, h)
    dec = MJPEGDecoder()
    lf, rf = src.grab()
    assert b"\xff\xc4" not in bytes(lf.data)[:6]  # really stripped
    out = dec.decode(lf.data, w, h)
    assert out is not None and out.shape == (h, w, 3)
    src.close()


def test_capability_gating(fake_kernel):
    """A device without streaming support must fail at QUERYCAP time with
    a clear error (v4l2-stream-stereo-device.cpp:22-38 parity), not an
    opaque errno later."""
    frames, _ = _mjpeg_frames(32, 32, 1)
    fake_kernel.add_device("/dev/video7", frames,
                           caps=v4l2._V4L2_CAP_VIDEO_CAPTURE)
    with pytest.raises(RuntimeError, match="streaming"):
        v4l2._Camera("/dev/video7", 32, 32)
    assert not fake_kernel.devices["/dev/video7"]["open"]


def test_dqbuf_requires_qbuf(fake_kernel):
    """The kernel rejects DQBUF with nothing queued; the source's
    QBUF-both-then-DQBUF-both ordering is what makes grab() legal."""
    frames, _ = _mjpeg_frames(32, 32, 1)
    fake_kernel.add_device("/dev/video1", frames)
    cam = v4l2._Camera("/dev/video1", 32, 32)
    with pytest.raises(OSError):
        cam.dequeue()  # nothing queued yet
    cam.queue()
    data = cam.dequeue()
    assert data == frames[0]
    with pytest.raises(OSError):
        cam.dequeue()  # consumed; kernel owns no queued buffer again
    cam.close()
