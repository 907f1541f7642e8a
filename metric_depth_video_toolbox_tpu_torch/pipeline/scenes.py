"""Scene detection + the scene CSV contract (a copy of the JAX package's
``pipeline/scenes.py``, numpy and cv2 only; cv2 is imported by the
detector).

The reference shells out to PySceneDetect (``scenedetect -i <video>
list-scenes``, movie_2_3D.py:221) and then parses its CSV (skipping the
first timestamp row). This module produces/consumes the SAME CSV format
with a built-in content detector (HSV histogram distance — the same
signal PySceneDetect's ContentDetector uses), so scene files
interoperate in both directions. Also provides the long-scene splitter
(cap 1500 frames, movie_2_3D.py:111-173).
"""

from __future__ import annotations

import csv
import os

import numpy as np

CSV_FIELDS = [
    "Scene Number", "Start Frame", "Start Timecode",
    "Start Time (seconds)", "End Frame", "End Timecode",
    "End Time (seconds)", "Length (frames)", "Length (seconds)",
    "Length (timecode)",
]


def _timecode(seconds):
    ms = round(seconds * 1000)
    s, ms = divmod(ms, 1000)
    m, s = divmod(s, 60)
    h, m = divmod(m, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def detect_scenes(color_video, threshold=0.35, min_scene_len=15):
    """Histogram-based cut detection -> list of scene dicts (CSV schema).

    threshold: normalized HSV-histogram distance in [0, 1] that counts as
    a cut. min_scene_len: minimum frames per scene.
    """
    import cv2
    cap = cv2.VideoCapture(color_video)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {color_video}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0

    cuts = [0]
    prev_hist = None
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        small = cv2.resize(frame, (160, 90), interpolation=cv2.INTER_AREA)
        hsv = cv2.cvtColor(small, cv2.COLOR_BGR2HSV)
        hist = cv2.calcHist([hsv], [0, 1, 2], None, [8, 8, 8],
                            [0, 180, 0, 256, 0, 256])
        hist = hist.reshape(-1)
        hist = hist / (hist.sum() + 1e-9)
        if prev_hist is not None:
            dist = 0.5 * np.abs(hist - prev_hist).sum()
            if dist > threshold and idx - cuts[-1] >= min_scene_len:
                cuts.append(idx)
        prev_hist = hist
        idx += 1
    cap.release()
    total = idx
    if total == 0:
        raise RuntimeError(f"no frames in {color_video}")
    cuts.append(total)

    scenes = []
    for i in range(len(cuts) - 1):
        sf, ef = cuts[i], cuts[i + 1] - 1
        ss, es = sf / fps, (ef + 1) / fps
        scenes.append({
            "Scene Number": str(i + 1),
            "Start Frame": str(sf),
            "Start Timecode": _timecode(ss),
            "Start Time (seconds)": f"{ss:.3f}",
            "End Frame": str(ef),
            "End Timecode": _timecode(es),
            "End Time (seconds)": f"{es:.3f}",
            "Length (frames)": str(ef - sf + 1),
            "Length (seconds)": f"{es - ss:.3f}",
            "Length (timecode)": _timecode(es - ss),
        })
    return scenes


def write_scene_csv(path, scenes):
    """PySceneDetect-compatible CSV: a first 'timecode list' row that
    parsers skip, then the header + rows."""
    fields = list(CSV_FIELDS)
    for s in scenes:  # extras (Engine/Infill/Convergence) in stable order
        for k in s:
            if k not in fields:
                fields.append(k)
    with open(path, "w", newline="", encoding="utf-8") as f:
        f.write("Timecode List:," + ",".join(
            s["Start Timecode"] for s in scenes[1:]) + "\n")
        writer = csv.DictWriter(f, fieldnames=fields, restval="")
        writer.writeheader()
        for s in scenes:
            writer.writerow(s)
    return path


def read_scene_csv(path, delimiter=","):
    """Parse a PySceneDetect CSV (skipping the first garbage row,
    reference movie_2_3D.py:233-241)."""
    with open(path, newline="", encoding="utf-8") as f:
        f.readline()  # timestamp list row
        rows = list(csv.DictReader(f, delimiter=delimiter))
    return rows


def split_scenes(scenes, max_scene_frames=1500):
    """Split scenes longer than the cap, renumber consecutively,
    preserving extra columns (Engine/Infill/Convergence overrides) —
    reference movie_2_3D.py:111-173."""
    out = []
    for scene in scenes:
        sf = int(scene["Start Frame"])
        ef = int(scene["End Frame"])
        ss = float(scene["Start Time (seconds)"])
        es = float(scene["End Time (seconds)"])
        length = ef - sf + 1
        spf = (es - ss) / (ef - sf) if ef != sf else 0.0

        def chunk(csf, cef):
            d = dict(scene)
            css = ss + (csf - sf) * spf
            ces = ss + (cef - sf) * spf
            d.update({
                "Start Frame": str(csf),
                "Start Time (seconds)": f"{css:.3f}",
                "Start Timecode": _timecode(css),
                "End Frame": str(cef),
                "End Time (seconds)": f"{ces:.3f}",
                "End Timecode": _timecode(ces),
                "Length (frames)": str(cef - csf + 1),
                "Length (seconds)": f"{max(0.0, ces - css):.3f}",
                "Length (timecode)": _timecode(max(0.0, ces - css)),
            })
            return d

        if length <= max_scene_frames:
            out.append(chunk(sf, ef))
            continue
        start = sf
        remaining = length
        while remaining > 0:
            n = min(remaining, max_scene_frames)
            out.append(chunk(start, start + n - 1))
            remaining -= n
            start += n
    for i, d in enumerate(out, start=1):
        d["Scene Number"] = str(i)
    return out


def ensure_scene_file(color_video, output_dir, scene_file=None):
    """Reuse an existing scene CSV or detect + write one
    (reference movie_2_3D.py:209-222 semantics, no subprocess)."""
    if scene_file is not None:
        return scene_file
    name = os.path.splitext(os.path.basename(color_video))[0]
    path = os.path.join(output_dir, name + "-Scenes.csv")
    if not os.path.exists(path):
        write_scene_csv(path, detect_scenes(color_video))
    return path
