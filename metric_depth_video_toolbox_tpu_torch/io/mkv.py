"""Native Matroska (MKV) metadata editing + audio remux — no ffmpeg (a
copy of the JAX package's pure-Python ``io/mkv.py``).

The reference tags its final SBS movie with ``stereo_mode=left_right``
and muxes the source's audio track into it through ffmpeg
(movie_2_3D.py:723-778); 3D players (VLC, Kodi, headsets) key off the
StereoMode metadata to enable side-by-side mode. An ffmpeg binary may
be absent, and cv2's writer cannot emit the tag or carry audio, so this
module remuxes the cv2-written MKV in pure Python: it parses the
EBML tree, appends a ``StereoMode`` element to the video track,
optionally copies the audio track(s) of a second Matroska file into
the output (codec-private + blocks copied verbatim — remux, no
transcode), and rewrites the file with recomputed sizes and
regenerated Cues (video clusters are copied payload-untouched).

Matroska StereoMode values (matroska.org spec):
  0 mono, 1 side-by-side left-first, 2 top-bottom right-first,
  3 top-bottom left-first, 11 side-by-side right-first.
"""

from __future__ import annotations

import os

# EBML / Matroska element IDs (raw, including the length-marker bits)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEEK_HEAD = 0x114D9B74
INFO = 0x1549A966
TRACKS = 0x1654AE6B
CLUSTER = 0x1F43B675
CUES = 0x1C53BB6B
TAGS = 0x1254C367
CHAPTERS = 0x1043A770
ATTACHMENTS = 0x1941A469
VOID = 0xEC
TRACK_ENTRY = 0xAE
TRACK_TYPE = 0x83
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
VIDEO = 0xE0
STEREO_MODE = 0x53B8
CLUSTER_TIMESTAMP = 0xE7
TIMESTAMP_SCALE = 0x2AD7B1
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_DURATION = 0x9B
CUE_POINT = 0xBB
CUE_TIME = 0xB3
CUE_TRACK_POSITIONS = 0xB7
CUE_TRACK = 0xF7
CUE_CLUSTER_POSITION = 0xF1

STEREO_SBS_LEFT_FIRST = 1
STEREO_TOP_BOTTOM_LEFT_FIRST = 3


def _read_id(buf, pos):
    """EBML element ID: length from leading-zero count of first byte."""
    first = buf[pos]
    for n in range(1, 5):
        if first & (0x80 >> (n - 1)):
            raw = int.from_bytes(buf[pos:pos + n], "big")
            return raw, pos + n
    raise ValueError(f"bad EBML ID at {pos}")


def _read_size(buf, pos):
    """EBML VINT size. Returns (value, new_pos, is_unknown)."""
    first = buf[pos]
    for n in range(1, 9):
        marker = 0x80 >> (n - 1)
        if first & marker:
            raw = int.from_bytes(buf[pos:pos + n], "big")
            val = raw - (marker << (8 * (n - 1)))
            unknown = val == (1 << (7 * n)) - 1
            return val, pos + n, unknown
    raise ValueError(f"bad EBML size at {pos}")


def _encode_id(eid):
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _encode_size(val, min_bytes=1):
    """Shortest VINT encoding of ``val`` (>= min_bytes)."""
    for n in range(min_bytes, 9):
        if val < (1 << (7 * n)) - 1:
            marker = 1 << (7 * n)
            return (marker | val).to_bytes(n, "big")
    raise ValueError("size too large")


def _encode_uint(val):
    n = max(1, (val.bit_length() + 7) // 8)
    return val.to_bytes(n, "big")


def _element(eid, payload):
    return _encode_id(eid) + _encode_size(len(payload)) + payload


def _iter_children(buf, start, end):
    """Yield (id, data_start, data_end, header_start) of each child."""
    pos = start
    while pos < end:
        eid, p1 = _read_id(buf, pos)
        size, p2, unknown = _read_size(buf, p1)
        data_end = end if unknown else p2 + size
        yield eid, p2, data_end, pos
        pos = data_end


def _parse_uint(buf, start, end):
    return int.from_bytes(buf[start:end], "big")


def _rebuild_tracks(buf, start, end, stereo_mode):
    """Rebuild the Tracks element with StereoMode appended to (or
    replaced in) every video TrackEntry's Video element. Returns
    (new_tracks_bytes, video_track_number)."""
    entries = []
    video_track_num = None
    for eid, ds, de, _ in _iter_children(buf, start, end):
        if eid != TRACK_ENTRY:
            if eid != VOID:
                entries.append(_element(eid, bytes(buf[ds:de])))
            continue
        # inspect the TrackEntry
        track_type = None
        track_num = None
        children = []
        for cid, cds, cde, chs in _iter_children(buf, ds, de):
            children.append((cid, cds, cde))
            if cid == TRACK_TYPE:
                track_type = _parse_uint(buf, cds, cde)
            elif cid == TRACK_NUMBER:
                track_num = _parse_uint(buf, cds, cde)
        payload = b""
        for cid, cds, cde in children:
            if cid == VIDEO and track_type == 1:
                # rebuild Video with StereoMode (replacing any existing)
                vp = b""
                for vid, vds, vde, _h in _iter_children(buf, cds, cde):
                    if vid != STEREO_MODE:
                        vp += _element(vid, bytes(buf[vds:vde]))
                vp += _element(STEREO_MODE, _encode_uint(stereo_mode))
                payload += _element(VIDEO, vp)
            else:
                payload += _element(cid, bytes(buf[cds:cde]))
        if track_type == 1 and video_track_num is None:
            video_track_num = track_num
            if not any(c[0] == VIDEO for c in children):
                # video track without a Video element (unusual): add one
                payload += _element(
                    VIDEO, _element(STEREO_MODE, _encode_uint(stereo_mode)))
        entries.append(_element(TRACK_ENTRY, payload))
    return _element(TRACKS, b"".join(entries)), video_track_num


def set_stereo_mode(path, mode=STEREO_SBS_LEFT_FIRST, out_path=None):
    """Remux ``path`` (MKV) with the video track tagged ``StereoMode``.

    Clusters are copied verbatim; Info/Tracks are rewritten; SeekHead
    is dropped and Cues regenerated (both hold absolute offsets that
    the rewrite invalidates). In-place when ``out_path`` is None (via a
    tmp file + rename). Returns the output path.
    """
    with open(path, "rb") as f:
        buf = f.read()

    # EBML header (copied verbatim)
    eid, p1 = _read_id(buf, 0)
    if eid != EBML_HEADER:
        raise ValueError(f"{path}: not an EBML/Matroska file")
    hsize, p2, _ = _read_size(buf, p1)
    header = bytes(buf[:p2 + hsize])

    seg_id, sp1 = _read_id(buf, p2 + hsize)
    if seg_id != SEGMENT:
        raise ValueError(f"{path}: no Segment element")
    seg_size, sp2, seg_unknown = _read_size(buf, sp1)
    seg_end = len(buf) if seg_unknown else sp2 + seg_size

    info = tracks = None
    clusters = []  # (header_start, data_start, data_end)
    keep_misc = []  # chapters/tags/attachments copied verbatim
    video_track_num = 1
    for eid2, ds, de, hs in _iter_children(buf, sp2, seg_end):
        if eid2 == INFO:
            info = _element(INFO, bytes(buf[ds:de]))
        elif eid2 == TRACKS:
            tracks, video_track_num = _rebuild_tracks(buf, ds, de, mode)
        elif eid2 == CLUSTER:
            clusters.append((hs, ds, de))
        elif eid2 in (TAGS, CHAPTERS, ATTACHMENTS):
            keep_misc.append(_element(eid2, bytes(buf[ds:de])))
        # SEEK_HEAD / CUES / VOID dropped (offsets invalidated)
    if tracks is None:
        raise ValueError(f"{path}: no Tracks element")
    if video_track_num is None:
        video_track_num = 1

    # layout: Info, Tracks, Clusters..., misc, Cues (at the end). Cue
    # positions are relative to the Segment data start.
    body_pre = (info or b"") + tracks
    cluster_blobs = [bytes(buf[hs:de]) for hs, ds, de in clusters]
    cluster_times = []
    for hs, ds, de in clusters:
        t = 0
        for cid, cds, cde, _h in _iter_children(buf, ds, de):
            if cid == CLUSTER_TIMESTAMP:
                t = _parse_uint(buf, cds, cde)
                break
        cluster_times.append(t)

    misc = b"".join(keep_misc)
    # two-pass: cue element size depends on itself only via placement
    # at the END, so positions are final before Cues is built
    positions = []
    off = len(body_pre)
    for blob in cluster_blobs:
        positions.append(off)
        off += len(blob)
    cues_payload = b""
    for t, pos in zip(cluster_times, positions):
        ctp = (_element(CUE_TRACK, _encode_uint(video_track_num))
               + _element(CUE_CLUSTER_POSITION, _encode_uint(pos)))
        cues_payload += _element(
            CUE_POINT, _element(CUE_TIME, _encode_uint(t))
            + _element(CUE_TRACK_POSITIONS, ctp))
    body = (body_pre + b"".join(cluster_blobs) + misc
            + _element(CUES, cues_payload))

    out = out_path or path
    tmp = os.path.join(os.path.dirname(os.path.abspath(out)),
                       f"_tmp_stereo_{os.path.basename(out)}")
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(_encode_id(SEGMENT) + _encode_size(len(body), 8))
        f.write(body)
    os.replace(tmp, out)
    return out


def _segment_bounds(buf, path=""):
    """-> (header_bytes, segment_data_start, segment_data_end)."""
    eid, p1 = _read_id(buf, 0)
    if eid != EBML_HEADER:
        raise ValueError(f"{path}: not an EBML/Matroska file")
    hsize, p2, _ = _read_size(buf, p1)
    seg_id, sp1 = _read_id(buf, p2 + hsize)
    if seg_id != SEGMENT:
        raise ValueError(f"{path}: no Segment element")
    seg_size, sp2, unknown = _read_size(buf, sp1)
    seg_end = len(buf) if unknown else sp2 + seg_size
    return bytes(buf[:p2 + hsize]), sp2, seg_end


def _timestamp_scale(buf, info_start, info_end):
    for cid, ds, de, _h in _iter_children(buf, info_start, info_end):
        if cid == TIMESTAMP_SCALE:
            return _parse_uint(buf, ds, de)
    return 1_000_000  # Matroska default (1 ms)


def _split_block_header(buf, start, end):
    """SimpleBlock/Block payload -> (track_num, rel_ts_s16, rest_bytes).
    ``rest`` = flags byte + (lacing +) frame data, copied verbatim."""
    num, p = _read_size(buf, start)[:2]
    rel = int.from_bytes(buf[p:p + 2], "big", signed=True)
    return num, rel, bytes(buf[p + 2:end])


def _collect_audio(buf, path=""):
    """Parse a Matroska file and pull out its audio side: returns
    (timestamp_scale, [(old_track_num, track_entry_children)], blocks)
    where blocks = [(abs_ts_src_scale, old_num, is_group, rest,
    group_children)] — ``rest`` is the block payload after the
    track/timestamp header (flags + lacing + coded frames, verbatim);
    ``group_children`` is the BlockGroup's non-Block children as
    (id, payload) pairs (BlockDuration etc.)."""
    header, sp2, seg_end = _segment_bounds(buf, path)
    del header
    scale = 1_000_000
    audio_tracks = []  # (old_num, [(child_id, payload), ...])
    audio_nums = set()
    blocks = []
    for eid, ds, de, _hs in _iter_children(buf, sp2, seg_end):
        if eid == INFO:
            scale = _timestamp_scale(buf, ds, de)
        elif eid == TRACKS:
            for tid, tds, tde, _h in _iter_children(buf, ds, de):
                if tid != TRACK_ENTRY:
                    continue
                ttype = tnum = None
                children = []
                for cid, cds, cde, _h2 in _iter_children(buf, tds, tde):
                    children.append((cid, bytes(buf[cds:cde])))
                    if cid == TRACK_TYPE:
                        ttype = _parse_uint(buf, cds, cde)
                    elif cid == TRACK_NUMBER:
                        tnum = _parse_uint(buf, cds, cde)
                if ttype == 2 and tnum is not None:  # audio
                    audio_tracks.append((tnum, children))
                    audio_nums.add(tnum)
        elif eid == CLUSTER:
            cts = 0
            for cid, cds, cde, _h in _iter_children(buf, ds, de):
                if cid == CLUSTER_TIMESTAMP:
                    cts = _parse_uint(buf, cds, cde)
                elif cid == SIMPLE_BLOCK:
                    num, rel, rest = _split_block_header(buf, cds, cde)
                    if num in audio_nums:
                        blocks.append((cts + rel, num, False, rest, []))
                elif cid == BLOCK_GROUP:
                    num = rel = rest = None
                    extra = []
                    for gid, gds, gde, _h2 in _iter_children(
                            buf, cds, cde):
                        if gid == BLOCK:
                            num, rel, rest = _split_block_header(
                                buf, gds, gde)
                        else:
                            extra.append((gid, bytes(buf[gds:gde])))
                    if num in audio_nums:
                        blocks.append((cts + rel, num, True, rest, extra))
    return scale, audio_tracks, blocks


def _emit_block(new_num, rel, is_group, rest, extra, dur_ratio):
    """Re-emit one audio block with a patched track number and
    cluster-relative timestamp."""
    body = (_encode_size(new_num)
            + int(rel).to_bytes(2, "big", signed=True) + rest)
    if not is_group:
        return _element(SIMPLE_BLOCK, body)
    payload = _element(BLOCK, body)
    for gid, gp in extra:
        if gid == BLOCK_DURATION and dur_ratio != 1.0:
            d = int(round(int.from_bytes(gp, "big") * dur_ratio))
            gp = _encode_uint(max(d, 0))
        payload += _element(gid, gp)
    return _element(BLOCK_GROUP, payload)


def mux_audio(video_path, audio_source_path, out_path=None,
              stereo_mode=None):
    """Copy the audio track(s) of ``audio_source_path`` (Matroska) into
    ``video_path`` — remux, no transcode (codec-private and coded
    frames are copied verbatim; only track numbers and cluster-relative
    timestamps are rewritten, with timestamp-scale conversion). The
    native stand-in for the reference's ffmpeg audio mux
    (movie_2_3D.py:723-778, ``-map 0:v -map 1:a? -c copy``) on hosts
    without an ffmpeg binary. ``stereo_mode``: also tag the video track
    in the same rewrite. In-place when ``out_path`` is None. Raises
    ValueError when the source is not Matroska or carries no audio
    (callers fall back to a warning, pipeline/movie.py step7).
    """
    import bisect

    with open(video_path, "rb") as f:
        vbuf = f.read()
    with open(audio_source_path, "rb") as f:
        abuf = f.read()

    src_scale, audio_tracks, audio_blocks = _collect_audio(
        abuf, audio_source_path)
    if not audio_tracks:
        raise ValueError(f"{audio_source_path}: no audio track found")

    header, sp2, seg_end = _segment_bounds(vbuf, video_path)
    info = tracks_payload = None
    dst_scale = 1_000_000
    clusters = []  # (cluster_ts, payload_bytes)
    keep_misc = []
    video_track_num = 1
    max_track_num = 0
    for eid, ds, de, _hs in _iter_children(vbuf, sp2, seg_end):
        if eid == INFO:
            info = _element(INFO, bytes(vbuf[ds:de]))
            dst_scale = _timestamp_scale(vbuf, ds, de)
        elif eid == TRACKS:
            if stereo_mode is not None:
                tracks_el, video_track_num = _rebuild_tracks(
                    vbuf, ds, de, stereo_mode)
                # strip the TRACKS wrapper to get the payload back
                _tid, tp1 = _read_id(tracks_el, 0)
                _sz, tp2, _u = _read_size(tracks_el, tp1)
                tracks_payload = tracks_el[tp2:]
            else:
                tracks_payload = bytes(vbuf[ds:de])
            for tid, tds, tde, _h in _iter_children(vbuf, ds, de):
                if tid != TRACK_ENTRY:
                    continue
                for cid, cds, cde, _h2 in _iter_children(vbuf, tds, tde):
                    if cid == TRACK_NUMBER:
                        max_track_num = max(
                            max_track_num, _parse_uint(vbuf, cds, cde))
        elif eid == CLUSTER:
            cts = 0
            for cid, cds, cde, _h in _iter_children(vbuf, ds, de):
                if cid == CLUSTER_TIMESTAMP:
                    cts = _parse_uint(vbuf, cds, cde)
                    break
            clusters.append((cts, bytes(vbuf[ds:de])))
        elif eid in (TAGS, CHAPTERS, ATTACHMENTS):
            keep_misc.append(_element(eid, bytes(vbuf[ds:de])))
    if tracks_payload is None:
        raise ValueError(f"{video_path}: no Tracks element")
    if not clusters:
        raise ValueError(f"{video_path}: no Clusters")

    # renumbered audio TrackEntries appended to the video's Tracks
    renum = {}
    new_entries = b""
    for i, (old_num, children) in enumerate(audio_tracks):
        new_num = max_track_num + 1 + i
        renum[old_num] = new_num
        payload = b""
        for cid, cp in children:
            if cid == TRACK_NUMBER:
                cp = _encode_uint(new_num)
            elif cid == TRACK_UID:  # avoid UID collisions across files
                cp = _encode_uint(0x4D445654 + new_num)
            payload += _element(cid, cp)
        new_entries += _element(TRACK_ENTRY, payload)
    tracks = _element(TRACKS, tracks_payload + new_entries)

    # audio block placement: source scale -> dest scale, then into the
    # video cluster whose timestamp precedes it (s16 relative range)
    ts_ratio = src_scale / dst_scale
    cluster_ts = [c[0] for c in clusters]
    extra_blocks = []  # beyond s16 range of the last cluster
    per_cluster = [[] for _ in clusters]
    for abs_src, old_num, is_group, rest, extra in audio_blocks:
        ts = int(round(abs_src * ts_ratio))
        idx = max(bisect.bisect_right(cluster_ts, ts) - 1, 0)
        rel = ts - cluster_ts[idx]
        if -32768 <= rel <= 32767:
            per_cluster[idx].append(
                _emit_block(renum[old_num], rel, is_group, rest, extra,
                            ts_ratio))
        else:
            extra_blocks.append((ts, renum[old_num], is_group, rest,
                                 extra))

    out_clusters = []
    for (cts, payload), audio in zip(clusters, per_cluster):
        if audio:
            payload = payload + b"".join(audio)
        out_clusters.append((cts, _element(CLUSTER, payload)))
    # trailing audio-only clusters (audio running past the last video
    # cluster's s16 window), 30 s each
    extra_blocks.sort(key=lambda b: b[0])
    i = 0
    while i < len(extra_blocks):
        base_ts = extra_blocks[i][0]
        payload = _element(CLUSTER_TIMESTAMP, _encode_uint(base_ts))
        while i < len(extra_blocks) and \
                extra_blocks[i][0] - base_ts <= 30_000:
            ts, num, is_group, rest, extra = extra_blocks[i]
            payload += _emit_block(num, ts - base_ts, is_group, rest,
                                   extra, ts_ratio)
            i += 1
        out_clusters.append((base_ts, _element(CLUSTER, payload)))

    # reassemble: Info, Tracks, Clusters, misc, regenerated Cues
    body_pre = (info or b"") + tracks
    positions = []
    off = len(body_pre)
    for _cts, blob in out_clusters:
        positions.append(off)
        off += len(blob)
    cues_payload = b""
    for (cts, _blob), pos in zip(out_clusters, positions):
        ctp = (_element(CUE_TRACK, _encode_uint(video_track_num or 1))
               + _element(CUE_CLUSTER_POSITION, _encode_uint(pos)))
        cues_payload += _element(
            CUE_POINT, _element(CUE_TIME, _encode_uint(cts))
            + _element(CUE_TRACK_POSITIONS, ctp))
    body = (body_pre + b"".join(b for _t, b in out_clusters)
            + b"".join(keep_misc) + _element(CUES, cues_payload))

    out = out_path or video_path
    tmp = os.path.join(os.path.dirname(os.path.abspath(out)),
                       f"_tmp_audio_{os.path.basename(out)}")
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(_encode_id(SEGMENT) + _encode_size(len(body), 8))
        f.write(body)
    os.replace(tmp, out)
    return out


def has_audio_track(path):
    """True if the Matroska file carries at least one audio track."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        _header, sp2, seg_end = _segment_bounds(buf, path)
    except ValueError:
        return False
    for eid, ds, de, _hs in _iter_children(buf, sp2, seg_end):
        if eid != TRACKS:
            continue
        for tid, tds, tde, _h in _iter_children(buf, ds, de):
            if tid != TRACK_ENTRY:
                continue
            for cid, cds, cde, _h2 in _iter_children(buf, tds, tde):
                if cid == TRACK_TYPE and _parse_uint(
                        buf, cds, cde) == 2:
                    return True
    return False


def get_stereo_mode(path):
    """Read back the StereoMode of the first video track (None if
    untagged) — used by tests and the movie pipeline's verification."""
    with open(path, "rb") as f:
        buf = f.read()
    eid, p1 = _read_id(buf, 0)
    hsize, p2, _ = _read_size(buf, p1)
    seg_id, sp1 = _read_id(buf, p2 + hsize)
    seg_size, sp2, seg_unknown = _read_size(buf, sp1)
    seg_end = len(buf) if seg_unknown else sp2 + seg_size
    for eid2, ds, de, _h in _iter_children(buf, sp2, seg_end):
        if eid2 != TRACKS:
            continue
        for tid, tds, tde, _h2 in _iter_children(buf, ds, de):
            if tid != TRACK_ENTRY:
                continue
            for cid, cds, cde, _h3 in _iter_children(buf, tds, tde):
                if cid == VIDEO:
                    for vid, vds, vde, _h4 in _iter_children(buf, cds, cde):
                        if vid == STEREO_MODE:
                            return _parse_uint(buf, vds, vde)
    return None
