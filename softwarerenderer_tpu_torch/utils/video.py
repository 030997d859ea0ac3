"""First-party video capture: uncompressed RGB AVI writer (+ reader).

The reference has no capture path at all — the closest it gets is the
live framebuffer on screen (MainWindow.cs:247-251).  This module records
presented frames to a standard RIFF/AVI container with raw BI_RGB video
('DIB ' / 24-bit bottom-up BGR), which every mainstream player opens and
which needs no external encoder (this image ships none).  Pair with the
device text overlay (ops/text.py) for fully headless gameplay captures:
`python -m softwarerenderer_tpu_torch.apps.dust2 --headless --offline
--burn-hud --record /tmp/out.avi --frames 300`.

`read_avi` parses the same subset back (round-trip tested) so recordings
are also a machine-checkable artifact, not just eyeball material.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


class AviWriter:
    """Incremental uncompressed-AVI writer.

    Frames are (H, W, 3) uint8 RGB (or (H, W, 4); alpha is dropped) and
    must all share the first frame's size.  Sizes in the RIFF tree are
    back-patched on close(), so the file is written in one pass with two
    seeks.  Rows are BGR, bottom-up, padded to 4 bytes per the DIB spec.
    """

    def __init__(self, path: str, fps: float = 30.0):
        if fps <= 0:
            raise ValueError("fps must be positive")
        self.path = path
        self.fps = float(fps)
        self._f = None
        self._size: Tuple[int, int] | None = None   # (W, H)
        self._index: List[Tuple[int, int]] = []     # (offset, nbytes)
        self._movi_start = 0

    def _open(self, w: int, h: int) -> None:
        f = open(self.path, "wb")
        self._f = f
        self._size = (w, h)
        rate = max(1, int(round(self.fps * 1000)))
        scale = 1000
        stride = (w * 3 + 3) & ~3
        frame_bytes = stride * h
        f.write(_fourcc("RIFF") + b"\0\0\0\0" + _fourcc("AVI "))
        # LIST hdrl
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            int(1e6 / self.fps),            # dwMicroSecPerFrame
            min(0xFFFFFFFF,
                frame_bytes * int(self.fps + 1)),  # dwMaxBytesPerSec
            0, _AVIF_HASINDEX,
            0,                              # dwTotalFrames (patched)
            0, 1, frame_bytes, w, h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4H",
            _fourcc("vids"), _fourcc("DIB "), 0, 0, 0,
            0, scale, rate, 0,
            0,                              # dwLength (patched)
            frame_bytes, -1, 0, 0, 0, int(w) & 0xFFFF, int(h) & 0xFFFF)
        strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                           frame_bytes, 0, 0, 0, 0)
        strl = (_fourcc("LIST")
                + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf))
                + _fourcc("strl")
                + _fourcc("strh") + struct.pack("<I", len(strh)) + strh
                + _fourcc("strf") + struct.pack("<I", len(strf)) + strf)
        hdrl_body = (_fourcc("avih") + struct.pack("<I", len(avih))
                     + avih + strl)
        f.write(_fourcc("LIST") + struct.pack("<I", 4 + len(hdrl_body))
                + _fourcc("hdrl") + hdrl_body)
        # LIST movi (size patched on close)
        self._movi_list_pos = f.tell()
        f.write(_fourcc("LIST") + b"\0\0\0\0" + _fourcc("movi"))
        self._movi_start = f.tell()          # first byte after 'movi'

    def add(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[2] not in (3, 4):
            raise ValueError(f"expected (H, W, 3|4) uint8, got "
                             f"{frame.shape}")
        if frame.dtype != np.uint8:
            if np.issubdtype(frame.dtype, np.floating):
                # accept raw [0, 1] render output (engine.to_rgb8's math)
                frame = (np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)
            else:
                raise ValueError(f"expected uint8 or float [0,1] frames, "
                                 f"got dtype {frame.dtype}")
        h, w = frame.shape[:2]
        if self._f is None:
            self._open(w, h)
        if (w, h) != self._size:
            raise ValueError(f"frame size {(w, h)} != first frame "
                             f"{self._size}")
        # RIFF sizes are u32: refuse a frame that would push the file
        # (movi data + 16-byte idx1 entries + headers) past 4 GiB —
        # close() could no longer back-patch valid sizes and the whole
        # recording would be unreadable.
        stride4 = (w * 3 + 3) & ~3
        projected = (self._f.tell() + 8 + stride4 * h
                     + 16 * (len(self._index) + 1) + 64)
        if projected > 0xFFFFFFFF:
            raise ValueError(
                "recording would exceed the 4 GiB RIFF/AVI size limit "
                f"({self.frames} frames so far); close() this writer and "
                "start a new file")
        bgr = frame[::-1, :, 2::-1]          # bottom-up, RGB→BGR
        stride = (w * 3 + 3) & ~3
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w * 3] = bgr.reshape(h, w * 3)
        data = rows.tobytes()
        # idx1 offsets are relative to the 'movi' fourcc (so the first
        # chunk sits at offset 4 — the widespread convention).
        self._index.append((self._f.tell() - self._movi_start + 4,
                            len(data)))
        self._f.write(_fourcc("00db") + struct.pack("<I", len(data))
                      + data)

    @property
    def frames(self) -> int:
        return len(self._index)

    def close(self) -> None:
        if self._f is None:
            return
        f, self._f = self._f, None
        movi_end = f.tell()
        idx = b"".join(
            _fourcc("00db") + struct.pack("<III", _AVIIF_KEYFRAME, off, n)
            for off, n in self._index)
        f.write(_fourcc("idx1") + struct.pack("<I", len(idx)) + idx)
        riff_end = f.tell()
        f.seek(4)
        f.write(struct.pack("<I", riff_end - 8))
        f.seek(self._movi_list_pos + 4)
        f.write(struct.pack("<I", movi_end - self._movi_list_pos - 8))
        n = len(self._index)
        # avih dwTotalFrames: RIFF hdr(12) + LIST hdrl(12) + avih
        # fourcc+size(8) + 16 bytes into avih
        f.seek(12 + 12 + 8 + 16)
        f.write(struct.pack("<I", n))
        # strh dwLength: ... + avih body(56) + LIST strl(12) + strh
        # fourcc+size(8) + 32 bytes into strh
        f.seek(12 + 12 + 8 + 56 + 12 + 8 + 32)
        f.write(struct.pack("<I", n))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi(path: str):
    """Parse back the subset AviWriter emits.

    Returns (frames (N, H, W, 3) uint8 RGB, fps).  Strict about the raw
    BI_RGB/24 layout; a foreign AVI with compressed video is rejected.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")

    w = h = None
    fps = 0.0
    frames: List[np.ndarray] = []

    def walk(lo: int, hi: int) -> None:
        nonlocal w, h, fps
        pos = lo
        while pos + 8 <= hi:
            ckid = data[pos:pos + 4]
            (n,) = struct.unpack_from("<I", data, pos + 4)
            body = pos + 8
            if ckid == b"LIST":
                walk(body + 4, body + n)
            elif ckid == b"strh":
                if data[body:body + 4] != b"vids":
                    raise ValueError("first stream is not video")
                scale, rate = struct.unpack_from("<II", data, body + 20)
                fps = rate / max(1, scale)
            elif ckid == b"strf":
                (size, bw, bh, _planes, bits, comp) = struct.unpack_from(
                    "<IiiHHI", data, body)
                if bits != 24 or comp != 0:
                    raise ValueError("only raw 24-bit BI_RGB supported")
                w, h = bw, abs(bh)
            elif ckid in (b"00db", b"00dc"):
                stride = (w * 3 + 3) & ~3
                raw = np.frombuffer(data, np.uint8, count=stride * h,
                                    offset=body).reshape(h, stride)
                bgr = raw[:, :w * 3].reshape(h, w, 3)
                frames.append(bgr[::-1, :, ::-1].copy())
            pos = body + n + (n & 1)

    walk(12, len(data))
    if w is None:
        raise ValueError("no video stream header found")
    return (np.stack(frames) if frames
            else np.zeros((0, h, w, 3), np.uint8)), fps
