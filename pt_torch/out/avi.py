"""Native MJPEG-AVI video writer (no external encoder).

Port of `pt.out.avi`. The reference's OutputSaver pipes raw frames to an
ffmpeg/libx264 subprocess (OutputSaver.cpp:64-111). Where no ffmpeg is
installed, video output would otherwise degrade to a PNG sequence; this
module keeps real video output available by writing a self-contained RIFF AVI 1.0
container with JPEG-compressed frames ('MJPG' fourcc — playable by
ffplay/VLC/browsers-via-transcode and decodable with any JPEG library).
Frame/size fields are patched on close, so the writer streams frames with
O(1) memory like the ffmpeg pipe does. The JPEG frames are Pillow's
(quality 95), as in `pt`; Pillow is imported only in `write_frame`.
"""

from __future__ import annotations

import io
import struct
from typing import List, Tuple

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


class MjpegAviWriter:
    """Streaming MJPEG AVI writer. Frames are (H, W, 3) uint8 RGB."""

    def __init__(self, path: str, width: int, height: int,
                 framerate: float = 30.0, quality: int = 92):
        self.path = path
        self.width = int(width)
        self.height = int(height)
        self.quality = int(quality)
        # fps as a rational with ms precision (dwRate / dwScale)
        self._scale = 1000
        self._rate = max(1, int(round(framerate * 1000)))
        self._entries: List[Tuple[int, int]] = []   # (chunk pos, jpeg size)
        self._max_chunk = 0
        self._f = open(path, "wb")
        self._write_headers()

    # -- container ---------------------------------------------------------
    def _write_headers(self) -> None:
        f = self._f
        f.write(b"RIFF")
        self._riff_size_pos = f.tell()
        f.write(struct.pack("<I", 0))               # patched on close
        f.write(b"AVI ")

        # LIST hdrl
        f.write(b"LIST")
        hdrl_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        hdrl_start = f.tell()
        f.write(b"hdrl")

        # avih: MainAVIHeader
        f.write(b"avih" + struct.pack("<I", 56))
        usec_per_frame = int(round(1e6 * self._scale / self._rate))
        # field offsets into the avih payload: dwTotalFrames is the 5th
        # dword (+16), dwSuggestedBufferSize the 8th (+28)
        self._avih_frames_pos = f.tell() + 16
        self._avih_bufsize_pos = f.tell() + 28
        f.write(struct.pack(
            "<14I", usec_per_frame, 0, 0, AVIF_HASINDEX,
            0,                                      # dwTotalFrames (patched)
            0, 1,                                   # initial frames, streams
            0,                                      # buffer size (patched)
            self.width, self.height, 0, 0, 0, 0))

        # LIST strl
        f.write(b"LIST")
        strl_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        strl_start = f.tell()
        f.write(b"strl")

        f.write(b"strh" + struct.pack("<I", 56))
        f.write(b"vids" + b"MJPG")
        # offsets past fccType/fccHandler: dwLength at +24, buffer at +28
        self._strh_length_pos = f.tell() + 24
        self._strh_bufsize_pos = f.tell() + 28
        f.write(struct.pack("<IHHIIIII", 0, 0, 0, 0,
                            self._scale, self._rate, 0,
                            0))                     # dwLength (patched)
        f.write(struct.pack("<IiI", 0, -1, 0))      # bufsize, quality, sample
        f.write(struct.pack("<4H", 0, 0, self.width, self.height))

        # strf: BITMAPINFOHEADER
        f.write(b"strf" + struct.pack("<I", 40))
        f.write(struct.pack("<IiiHH", 40, self.width, self.height, 1, 24))
        f.write(b"MJPG")
        f.write(struct.pack("<IiiII", self.width * self.height * 3,
                            0, 0, 0, 0))

        end = f.tell()
        f.seek(strl_size_pos)
        f.write(struct.pack("<I", end - strl_start))
        f.seek(hdrl_size_pos)
        f.write(struct.pack("<I", end - hdrl_start))
        f.seek(end)

        # LIST movi
        f.write(b"LIST")
        self._movi_size_pos = f.tell()
        f.write(struct.pack("<I", 0))
        self._movi_start = f.tell()                 # at the 'movi' fourcc
        f.write(b"movi")

    # -- frames ------------------------------------------------------------
    def write_frame(self, rgb: np.ndarray) -> None:
        from PIL import Image

        rgb = np.ascontiguousarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        assert rgb.shape == (self.height, self.width, 3), rgb.shape
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", quality=self.quality)
        data = buf.getvalue()

        f = self._f
        pos = f.tell()
        f.write(b"00dc" + struct.pack("<I", len(data)))
        f.write(data)
        if len(data) & 1:
            f.write(b"\x00")                        # RIFF chunks are even
        self._entries.append((pos, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))

    # -- finalize ----------------------------------------------------------
    def close(self) -> None:
        if self._f is None:
            return
        f = self._f
        movi_end = f.tell()

        # idx1: offsets measured from the 'movi' fourcc
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._entries)))
        for pos, size in self._entries:
            f.write(b"00dc" + struct.pack(
                "<III", AVIIF_KEYFRAME, pos - self._movi_start, size))
        riff_end = f.tell()

        n = len(self._entries)
        f.seek(self._riff_size_pos)
        f.write(struct.pack("<I", riff_end - (self._riff_size_pos + 4)))
        f.seek(self._avih_frames_pos)
        f.write(struct.pack("<I", n))
        f.seek(self._avih_bufsize_pos)
        f.write(struct.pack("<I", self._max_chunk + 8))
        f.seek(self._strh_length_pos)
        f.write(struct.pack("<I", n))
        f.seek(self._strh_bufsize_pos)
        f.write(struct.pack("<I", self._max_chunk + 8))
        f.seek(self._movi_size_pos)
        f.write(struct.pack("<I", movi_end - self._movi_start))
        f.close()
        self._f = None

    @property
    def frame_count(self) -> int:
        return len(self._entries)
