"""V4L2 ABI layer tests (reference: v4l2-stream-stereo-device.cpp:13-133).

The ctypes struct layouts are asserted against linux/videodev2.h ground
truth (64-bit ABI), and the full QUERYCAP->S_FMT->REQBUFS->QUERYBUF->mmap->
STREAMON->QBUF/DQBUF flow is driven end-to-end against a fake-kernel ioctl
that reads/writes the raw bytes at the kernel's offsets -- so a misdeclared
field breaks the test the same way it would break a real capture.
"""

import ctypes

import pytest

from rt_depth_map.sources import v4l2 as v4l2mod
from rt_depth_map.sources.v4l2 import (
    _v4l2_buffer,
    _v4l2_format,
    _v4l2_pix_format,
    _v4l2_requestbuffers,
    _v4l2_timecode,
)


def _ioc(direction, nr, size):
    return (direction << 30) | (size << 16) | (ord("V") << 8) | nr


class TestStructLayout:
    def test_buffer_size_and_offsets(self):
        # linux/videodev2.h struct v4l2_buffer on 64-bit
        assert ctypes.sizeof(_v4l2_buffer) == 88
        off = {f: getattr(_v4l2_buffer, f).offset for f, *_ in (
            (n,) for n, _ in _v4l2_buffer._fields_)}
        assert off["index"] == 0
        assert off["type"] == 4
        assert off["bytesused"] == 8
        assert off["flags"] == 12
        assert off["field"] == 16
        assert off["timestamp"] == 24  # struct timeval, 8-byte aligned
        assert off["timecode"] == 40
        assert off["sequence"] == 56
        assert off["memory"] == 60
        assert off["m"] == 64  # union with pointers, 8-byte aligned
        assert off["length"] == 72
        assert off["reserved2"] == 76
        assert off["request_fd"] == 80

    def test_timecode_is_16_bytes(self):
        assert ctypes.sizeof(_v4l2_timecode) == 16

    def test_format_layout(self):
        assert ctypes.sizeof(_v4l2_format) == 208
        assert _v4l2_format.fmt.offset == 8  # union is 8-byte aligned
        assert ctypes.sizeof(_v4l2_pix_format) == 48

    def test_requestbuffers_layout(self):
        assert ctypes.sizeof(_v4l2_requestbuffers) == 20

    def test_ioctl_numbers_match_struct_sizes(self):
        # _IOWR encodes sizeof(arg): if the struct were the wrong size the
        # kernel would reject the ioctl with ENOTTY/EINVAL.
        IOW, IOR, IOWR = 1, 2, 3
        assert v4l2mod._VIDIOC_S_FMT == _ioc(IOWR, 5, ctypes.sizeof(_v4l2_format))
        assert v4l2mod._VIDIOC_REQBUFS == _ioc(
            IOWR, 8, ctypes.sizeof(_v4l2_requestbuffers))
        assert v4l2mod._VIDIOC_QUERYBUF == _ioc(
            IOWR, 9, ctypes.sizeof(_v4l2_buffer))
        assert v4l2mod._VIDIOC_QBUF == _ioc(IOWR, 15, ctypes.sizeof(_v4l2_buffer))
        assert v4l2mod._VIDIOC_DQBUF == _ioc(IOWR, 17, ctypes.sizeof(_v4l2_buffer))
        assert v4l2mod._VIDIOC_STREAMON == _ioc(IOW, 18, 4)
        assert v4l2mod._VIDIOC_STREAMOFF == _ioc(IOW, 19, 4)


def _u32_at(arg, byte_off):
    return ctypes.cast(
        ctypes.addressof(arg) + byte_off, ctypes.POINTER(ctypes.c_uint32)
    ).contents.value


def _set_u32_at(arg, byte_off, value):
    ctypes.cast(
        ctypes.addressof(arg) + byte_off, ctypes.POINTER(ctypes.c_uint32)
    ).contents.value = value


class _FakeKernel:
    """Answers the capture ioctls by touching raw bytes at the REAL kernel
    offsets, independent of the ctypes declarations under test."""

    BUF_LEN = 65536
    MMAP_OFF = 4096
    FRAME = b"\xff\xd8fake-mjpeg\xff\xd9"

    def __init__(self):
        self.per_fd = {}
        self.next_fd = 100
        self.calls = []

    def open(self, path, flags):
        fd = self.next_fd
        self.next_fd += 1
        self.per_fd[fd] = {"queued": False, "streaming": False, "fmt": None}
        return fd

    def close(self, fd):
        self.per_fd.pop(fd)

    # capabilities the fake device advertises (QUERYCAP)
    CAPS = v4l2mod._V4L2_CAP_VIDEO_CAPTURE | v4l2mod._V4L2_CAP_STREAMING

    def ioctl(self, fd, req, arg):
        st = self.per_fd[fd]
        self.calls.append((fd, req))
        if req == v4l2mod._VIDIOC_QUERYCAP:
            assert st["fmt"] is None, "QUERYCAP must run before S_FMT"
            # kernel writes card at offset 16, capabilities at offset 84
            ctypes.memmove(ctypes.addressof(arg) + 16, b"fake-cam\0", 9)
            _set_u32_at(arg, 84, self.CAPS)
        elif req == v4l2mod._VIDIOC_S_FMT:
            # kernel reads fmt at offset 8: width, height, pixelformat
            w = _u32_at(arg, 8)
            h = _u32_at(arg, 12)
            pixfmt = _u32_at(arg, 16)
            assert _u32_at(arg, 0) == 1  # type == VIDEO_CAPTURE
            assert pixfmt == v4l2mod._V4L2_PIX_FMT_MJPEG, hex(pixfmt)
            st["fmt"] = (w, h)
            _set_u32_at(arg, 28, self.BUF_LEN)  # sizeimage
        elif req == v4l2mod._VIDIOC_REQBUFS:
            assert _u32_at(arg, 0) == 1  # count
            assert _u32_at(arg, 4) == 1  # type
            assert _u32_at(arg, 8) == v4l2mod._V4L2_MEMORY_MMAP
        elif req == v4l2mod._VIDIOC_QUERYBUF:
            assert _u32_at(arg, 0) == 0  # index
            assert _u32_at(arg, 4) == 1  # type
            _set_u32_at(arg, 64, self.MMAP_OFF)  # m.offset
            _set_u32_at(arg, 72, self.BUF_LEN)  # length
        elif req == v4l2mod._VIDIOC_QBUF:
            assert _u32_at(arg, 0) == 0  # index
            assert _u32_at(arg, 4) == 1  # type
            assert _u32_at(arg, 60) == v4l2mod._V4L2_MEMORY_MMAP  # memory
            st["queued"] = True
        elif req == v4l2mod._VIDIOC_DQBUF:
            assert st["queued"], "DQBUF before QBUF"
            st["queued"] = False
            _set_u32_at(arg, 8, len(self.FRAME))  # bytesused
        elif req in (v4l2mod._VIDIOC_STREAMON, v4l2mod._VIDIOC_STREAMOFF):
            assert isinstance(arg, ctypes.c_int)
            st["streaming"] = req == v4l2mod._VIDIOC_STREAMON
        else:
            raise AssertionError(f"unexpected ioctl {hex(req)}")
        return 0

    def mmap(self, fd, length, flags, prot, offset=0):
        assert length == self.BUF_LEN
        assert offset == self.MMAP_OFF
        return _FakeMmap(self.FRAME + b"\0" * (length - len(self.FRAME)))


class _FakeMmap:
    def __init__(self, data):
        self._data = data

    def __getitem__(self, key):
        return self._data[key]

    def close(self):
        pass


@pytest.fixture
def fake_kernel(monkeypatch):
    k = _FakeKernel()

    class FakeOs:
        O_RDWR = 2
        open = staticmethod(k.open)
        close = staticmethod(k.close)

    class FakeFcntl:
        ioctl = staticmethod(k.ioctl)

    class FakeMmapMod:
        MAP_SHARED = 1
        PROT_READ = 1
        PROT_WRITE = 2
        mmap = staticmethod(k.mmap)

    monkeypatch.setattr(v4l2mod, "os", FakeOs)
    monkeypatch.setattr(v4l2mod, "fcntl", FakeFcntl)
    monkeypatch.setattr(v4l2mod, "mmap", FakeMmapMod)
    return k


class TestCaptureFlow:
    def test_grab_one_frame(self, fake_kernel):
        src = v4l2mod.V4L2StereoSource("/dev/video1", "/dev/video0", 1280, 720)
        for st in fake_kernel.per_fd.values():
            assert st["fmt"] == (1280, 720)
            assert st["streaming"]
        lf, rf = src.grab()
        assert lf.encoding == "mjpeg" and rf.encoding == "mjpeg"
        assert lf.data == fake_kernel.FRAME
        assert rf.data == fake_kernel.FRAME
        src.close()
        assert not fake_kernel.per_fd  # both fds closed

    def test_qbuf_both_before_dqbuf_both(self, fake_kernel):
        # reference sync order: QBUF L, QBUF R, DQBUF L, DQBUF R
        src = v4l2mod.V4L2StereoSource("/dev/video1", "/dev/video0", 640, 480)
        fake_kernel.calls.clear()
        src.grab()
        kinds = [
            r for _, r in fake_kernel.calls
            if r in (v4l2mod._VIDIOC_QBUF, v4l2mod._VIDIOC_DQBUF)
        ]
        assert kinds == [
            v4l2mod._VIDIOC_QBUF, v4l2mod._VIDIOC_QBUF,
            v4l2mod._VIDIOC_DQBUF, v4l2mod._VIDIOC_DQBUF,
        ]
        src.close()
