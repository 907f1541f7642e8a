"""Lossless video I/O (port of ``io/video.py``): the filesystem contract
between stages.

Same on-disk formats as the JAX package (lossless FFV1/HuffYUV .mkv,
RGB-encoded depth) and the same atomic commit: writers stream to
``_tmp_<name>`` and :func:`verify_and_move` re-opens the file, checks the
frame count and renames it over the target. Readers batch frames and can
prefetch on a background thread.

OpenCV is imported when a reader or writer is opened, not when this
module is imported, so the package's in-memory paths run without it.
RGB channel order everywhere; BGR exists only at the cv2 boundary here.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.ops import codec

FFV1 = "FFV1"


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV (cv2) is required for video file "
                           "I/O") from e
    return cv2


def lossless_fourcc(width, height):
    """HuffYUV for even frame sizes, FFV1 otherwise;
    ``MDVT_LOSSLESS_CODEC`` overrides."""
    env = os.environ.get("MDVT_LOSSLESS_CODEC")
    if env:
        return env
    if width % 2 == 0 and height % 2 == 0:
        return "HFYU"
    return FFV1


class VideoReader:
    """Streaming frame reader (RGB uint8). Context manager."""

    def __init__(self, path, start_frame=0, max_frames=-1):
        cv2 = _cv2()
        if not os.path.exists(path):
            raise FileNotFoundError(f"video file {path} does not exist")
        self.path = path
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"failed to open video: {path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._remaining = max_frames
        for _ in range(start_frame):
            if not self.cap.grab():
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self.cap is not None:
            self.cap.release()
            self.cap = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._remaining == 0:
            raise StopIteration
        ok, frame = self.cap.read()
        if not ok:
            raise StopIteration
        if self._remaining > 0:
            self._remaining -= 1
        return frame[..., ::-1].copy()     # BGR -> RGB

    def read_frame(self, n):
        """Frame ``n`` (RGB uint8), None past the end. Seeks by
        CAP_PROP_POS_FRAMES, exact on the intra-only codecs written here
        (FFV1, HuffYUV)."""
        self.cap.set(_cv2().CAP_PROP_POS_FRAMES, n)
        ok, frame = self.cap.read()
        if not ok:
            return None
        return frame[..., ::-1].copy()

    def read_batch(self, batch_size):
        """Up to ``batch_size`` frames as (T, H, W, 3) uint8, None at the
        end of the stream."""
        frames = []
        for frame in self:
            frames.append(frame)
            if len(frames) == batch_size:
                break
        if not frames:
            return None
        return np.stack(frames)

    def read_all(self):
        batch = self.read_batch(1 << 62)
        return batch if batch is not None else np.zeros(
            (0, self.height, self.width, 3), np.uint8)


def read_video_frames(path, start_frame=0, max_frames=-1, target_fps=-1):
    """Whole-video load -> (frames (T, H, W, 3) uint8 RGB, fps);
    ``target_fps`` > 0 decimates to about that rate."""
    with VideoReader(path, start_frame, max_frames) as r:
        frames = r.read_all()
        if frames.shape[0] == 0:
            raise RuntimeError(f"no frames read from {path}")
        fps = r.fps
        if target_fps and 0 < target_fps < fps:
            stride = max(1, int(round(fps / target_fps)))
            frames = frames[::stride]
            fps = fps / stride
        return frames, fps


def video_info(path):
    """(frame_count, width, height, fps) without decoding."""
    with VideoReader(path) as r:
        return r.frame_count, r.width, r.height, r.fps


class PrefetchingBatchReader:
    """Batched reader whose decode of batch N+1 runs on a background
    thread while the caller works on batch N. ``close()`` stops it."""

    def __init__(self, path, batch_size, start_frame=0, max_frames=-1,
                 depth=2):
        self.reader = VideoReader(path, start_frame, max_frames)
        self.fps = self.reader.fps
        self.frame_count = self.reader.frame_count
        self.width = self.reader.width
        self.height = self.reader.height
        self._q = queue.Queue(maxsize=depth)
        self._batch_size = batch_size
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _work(self):
        try:
            while not self._stop.is_set():
                batch = self.reader.read_batch(self._batch_size)
                if batch is None:
                    break
                self._put(batch)
        finally:
            self._put(None)     # the end-of-stream sentinel
            self.reader.close()

    def read_batch(self, batch_size=None):
        """The next prefetched batch (None at the end); the batch size is
        fixed at construction."""
        del batch_size
        return self._q.get()

    def close(self):
        self._stop.set()
        while True:     # drain so the worker can leave a blocked put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)


class VideoWriter:
    """Streaming lossless writer (RGB uint8 in) with atomic commit.
    ``commit()`` verifies the frame count and renames over the target."""

    def __init__(self, path, fps, width, height, codec_fourcc=None,
                 tmp_path=None):
        cv2 = _cv2()
        self.path = path
        self.tmp_path = tmp_path or _tmp_name(path)
        self.width = int(width)
        self.height = int(height)
        self.frames_written = 0
        if codec_fourcc is None:
            codec_fourcc = lossless_fourcc(self.width, self.height)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.writer = cv2.VideoWriter(
            self.tmp_path, cv2.VideoWriter_fourcc(*codec_fourcc), fps,
            (self.width, self.height))
        if not self.writer.isOpened():
            raise RuntimeError(f"failed to open VideoWriter for {path}")

    def write(self, frame_rgb):
        frame_rgb = np.asarray(frame_rgb)
        if frame_rgb.dtype != np.uint8:
            frame_rgb = np.clip(frame_rgb, 0, 255).astype(np.uint8)
        if frame_rgb.shape[:2] != (self.height, self.width):
            frame_rgb = _cv2().resize(frame_rgb, (self.width, self.height),
                                      interpolation=_cv2().INTER_LINEAR)
        self.writer.write(np.ascontiguousarray(frame_rgb[..., ::-1]))
        self.frames_written += 1

    def write_batch(self, frames_rgb):
        for f in np.asarray(frames_rgb):
            self.write(f)

    def close(self):
        if self.writer is not None:
            self.writer.release()
            self.writer = None

    def commit(self, expected_frames=None):
        """Close, verify the frame count, move into place."""
        self.close()
        expected = (self.frames_written if expected_frames is None
                    else expected_frames)
        return verify_and_move(self.tmp_path, expected, self.path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
        else:
            self.close()


class AsyncVideoWriter:
    """:class:`VideoWriter` whose encode runs on a background thread; an
    encode error surfaces at the next ``write`` or at ``commit``."""

    def __init__(self, path, fps, width, height, codec_fourcc=None,
                 depth=8):
        self.writer = VideoWriter(path, fps, width, height, codec_fourcc)
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            frame = self._q.get()
            if frame is None:
                return
            try:
                self.writer.write(frame)
            except Exception as e:  # noqa: BLE001 - re-raised in the caller
                self._err = e
                return

    def write(self, frame_rgb):
        if self._err is not None:
            raise self._err
        self._q.put(frame_rgb)

    def commit(self, expected_frames=None):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self.writer.commit(expected_frames)


def _tmp_name(path):
    d, b = os.path.split(path)
    return os.path.join(d, f"_tmp_{b}")


def verify_and_move(tmp_file, expected_frames, output_file):
    """Re-open the tmp file, check its frame count, rename it over the
    output. False when the file is missing, unreadable or short."""
    cv2 = _cv2()
    if not os.path.isfile(tmp_file):
        return False
    cap = cv2.VideoCapture(tmp_file)
    if not cap.isOpened():
        return False
    actual = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if actual != expected_frames:
        print(f"{tmp_file}: wrong frame count {actual} != {expected_frames}")
        return False
    os.replace(tmp_file, output_file)
    return True


def is_valid_video(path, min_bytes=2048):
    return os.path.isfile(path) and os.path.getsize(path) >= min_bytes


def save_depth_video(depth_frames, path, fps, max_depth, bit16=True):
    """Float metric depth (T, H, W) -> RGB-encoded lossless video."""
    depth = torch.as_tensor(np.asarray(depth_frames, np.float32))
    t, h, w = depth.shape
    rgb = codec.encode_depth_frame(depth, max_depth, bit16=bit16).numpy()
    with VideoWriter(path, fps, w, h) as vw:
        for i in range(t):
            vw.write(rgb[i])
    return True


class DepthVideoReader(VideoReader):
    """Reads an RGB-encoded metric depth video as float meters."""

    def __init__(self, path, max_depth, bit16=True, average_rg=True, **kw):
        super().__init__(path, **kw)
        self.max_depth = max_depth
        self.bit16 = bit16
        self.average_rg = average_rg

    def read_depth_batch(self, batch_size):
        rgb = self.read_batch(batch_size)
        if rgb is None:
            return None
        return codec.decode_depth_frame(
            torch.from_numpy(rgb), self.max_depth, bit16=self.bit16,
            average_rg=self.average_rg).numpy()


def save_grayscale_video(frames, path, fps, max_value, width=None,
                         height=None):
    """Float frames (T, H, W[, 1]) -> 8-bit grayscale (R = G = B) lossless
    video, clipped to [0, max_value] and scaled by max_value (by the
    largest value, at least 1, when max_value <= 0)."""
    frames = np.asarray(frames)
    h, w = frames.shape[1:3]
    denom = max_value if max_value > 0 else max(float(frames.max()), 1.0)
    with VideoWriter(path, fps, width or w, height or h) as vw:
        for f in frames:
            if f.ndim == 3 and f.shape[-1] == 1:
                f = f[..., 0]
            g = (np.clip(f, 0, max_value) / denom * 255.0).astype(np.uint8)
            vw.write(np.stack([g, g, g], axis=-1))
    return True


def save_rgb_video(frames, path, fps):
    """uint8 RGB frames (T, H, W, 3) -> lossless video."""
    frames = np.asarray(frames)
    h, w = frames.shape[1:3]
    with VideoWriter(path, fps, w, h) as vw:
        vw.write_batch(frames)
    return True
