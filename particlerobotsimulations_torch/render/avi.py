"""Minimal AVI writer: MJPEG ('MJPG') or uncompressed ('DIB ') streams.

Port of ``particlerobotsimulations_tpu.render.avi`` (copied); the JPEG
frames come from the port's build of ``native/mjpeg.cpp``.

Replaces the reference's OpenCV ``cv::VideoWriter`` XVID pipeline
(postprocess.cu:99-116) without external codec
dependencies.  The default MJPG stream stores one baseline JPEG per frame
(encoded by native/mjpeg.cpp, ~10-50x smaller than raw) — a format every
stock player opens; 'DIB ' writes raw bottom-up BGR24 frames.  Frame rate
defaults to the reference's 20 FPS (postprocess.cu:102).

The writer streams frames to disk and patches the RIFF size fields plus the
index on close, so arbitrarily long recordings don't buffer in memory.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from . import native


def _fourcc(s: str) -> bytes:
    return s.encode("ascii")


class AviWriter:
    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: int = 20,
        codec: str = "MJPG",
        quality: int = 90,
    ):
        if width % 4 or height % 4:
            raise ValueError("width/height must be multiples of 4")
        if codec not in ("MJPG", "DIB "):
            raise ValueError(f"unsupported codec {codec!r}")
        self.path = path
        self.w = width
        self.h = height
        self.fps = fps
        self.codec = codec
        self.quality = quality
        self.frame_size = width * height * 3  # raw size == suggested buffer
        self._chunk_id = _fourcc("00dc" if codec == "MJPG" else "00db")
        self._frames = 0
        self._index: list[tuple[int, int]] = []
        self._fp: BinaryIO | None = open(path, "wb")
        self._write_headers()

    # -------------------------------------------------------------- headers

    def _write_headers(self):
        fp = self._fp
        # placeholder sizes; patched on close
        fp.write(_fourcc("RIFF") + struct.pack("<I", 0) + _fourcc("AVI "))
        # hdrl list
        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            int(1e6 // self.fps),  # microseconds per frame
            self.frame_size * self.fps,  # max bytes/sec
            0,  # padding
            0x10,  # flags: AVIF_HASINDEX
            0,  # total frames (patched)
            0,
            1,  # streams
            self.frame_size,
            self.w,
            self.h,
            0, 0, 0, 0,
        )
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            _fourcc("vids"), _fourcc(self.codec),
            0,             # dwFlags
            0, 0,          # wPriority, wLanguage
            0,             # dwInitialFrames
            1, self.fps,   # dwScale / dwRate
            0,             # dwStart
            0,             # dwLength (patched on close)
            self.frame_size,   # dwSuggestedBufferSize
            0xFFFFFFFF,    # dwQuality
            0,             # dwSampleSize
            0, 0, self.w, self.h,  # rcFrame
        )
        # BITMAPINFOHEADER: biCompression = 'MJPG' fourcc or BI_RGB (0)
        compression = (
            struct.unpack("<I", _fourcc("MJPG"))[0] if self.codec == "MJPG" else 0
        )
        strf = struct.pack(
            "<IiiHHIIiiII",
            40, self.w, self.h, 1, 24, compression, self.frame_size, 0, 0, 0, 0
        )

        def chunk(cc, payload):
            pad = b"\0" if len(payload) % 2 else b""
            return _fourcc(cc) + struct.pack("<I", len(payload)) + payload + pad

        strl = chunk("strh", strh) + chunk("strf", strf)
        strl_list = _fourcc("LIST") + struct.pack("<I", 4 + len(strl)) + _fourcc("strl") + strl
        hdrl = chunk("avih", avih) + strl_list
        hdrl_list = _fourcc("LIST") + struct.pack("<I", 4 + len(hdrl)) + _fourcc("hdrl") + hdrl
        fp.write(hdrl_list)
        # movi list (size patched)
        self._movi_size_pos = fp.tell() + 4
        fp.write(_fourcc("LIST") + struct.pack("<I", 0) + _fourcc("movi"))
        self._movi_start = fp.tell()

    # --------------------------------------------------------------- frames

    def write_frame(self, rgb: np.ndarray):
        """rgb: (h, w, 3) uint8, row 0 = top of image."""
        if rgb.shape != (self.h, self.w, 3):
            raise ValueError(f"frame must be ({self.h}, {self.w}, 3)")
        if self.codec == "MJPG":
            data = native.encode_jpeg(rgb, quality=self.quality)
        else:
            # DIB frames are bottom-up BGR
            bgr = rgb[::-1, :, ::-1]
            data = np.ascontiguousarray(bgr).tobytes()
        fp = self._fp
        # idx1 offsets are conventionally measured from the 'movi' list
        # fourcc, so the first chunk sits at offset 4 (not 0) — strict
        # parsers mis-seek otherwise
        offset = fp.tell() - self._movi_start + 4
        fp.write(self._chunk_id + struct.pack("<I", len(data)))
        fp.write(data)
        if len(data) % 2:
            fp.write(b"\0")
        self._index.append((offset, len(data)))
        self._frames += 1

    # ---------------------------------------------------------------- close

    def close(self):
        if self._fp is None:
            return
        fp = self._fp
        movi_end = fp.tell()
        # idx1 (AVIIF_KEYFRAME on every entry: MJPEG frames are independent)
        fp.write(_fourcc("idx1") + struct.pack("<I", 16 * len(self._index)))
        for off, size in self._index:
            fp.write(self._chunk_id + struct.pack("<III", 0x10, off, size))
        total = fp.tell()
        # patch sizes
        fp.seek(4)
        fp.write(struct.pack("<I", total - 8))
        fp.seek(self._movi_size_pos)
        fp.write(struct.pack("<I", movi_end - self._movi_size_pos - 4))
        # patch frame counts: avih dwTotalFrames and strh dwLength
        fp.seek(12 + 12 + 8 + 16)
        fp.write(struct.pack("<I", self._frames))
        # strh dwLength sits 32 bytes into the strh payload
        # layout: RIFF(12) LIST hdrl(12) avih chunk(8+56) LIST strl(12) strh(8) + 32
        strh_len_off = 12 + 12 + 8 + 56 + 12 + 8 + 32
        fp.seek(strh_len_off)
        fp.write(struct.pack("<I", self._frames))
        fp.close()
        self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
