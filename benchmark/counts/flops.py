"""Operations and bytes that the benchmark's work needs, counted from
shapes: what the published algorithm computes, never what the program
launched. A multiply-add counts as 2 operations; LayerNorm, softmax,
resizes and other elementwise work are left out of the operation counts.

Also frozen here: the byte count of the disparity sweep (``sweep_work``,
from the port's ``chip_smoke.py``) and the bound arithmetic beside it.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
SCALES = (4, 2, 1, 0.5)


def peaks(kind):
    """The table's peaks of a device name, or None for a card it lacks."""
    return PEAKS.get(kind)


def attention_flops(seq, dim, groups=1):
    """QK^T and PV over ``groups`` sequences of ``seq`` tokens, all heads
    together ``dim`` wide: 4 * seq^2 * dim per sequence."""
    return 4 * groups * seq * seq * dim


def vit_flops(vit, grid, images, view_group=1):
    """A ViT over ``images`` images of a (gh, gw) patch grid; the blocks of
    ``cross_view_indices`` attend over groups of ``view_group`` images."""
    gh, gw = grid
    d, ps = vit["embed_dim"], vit["patch_size"]
    n = gh * gw + 1
    hidden = int(d * vit["mlp_ratio"])
    cross = set(vit.get("cross_view_indices", ()))
    total = 2 * images * gh * gw * d * 3 * ps * ps        # patch embedding
    for i in range(vit["depth"]):
        total += images * n * 2 * d * (3 * d + d + 2 * hidden)
        g = view_group if i in cross and view_group > 1 else 1
        total += attention_flops(g * n, d, groups=images // g)
    return total


def conv_flops(pixels, c_in, c_out, k):
    return 2 * pixels * k * k * c_in * c_out


def temporal_flops(frames, pixels, dim, layers=1):
    """A motion module over ``frames`` frames of ``pixels`` tokens: proj_in,
    per block two temporal attentions (q, k, v, out and the scores over the
    frame axis) and the GEGLU feed-forward (8 C then 4 C -> C), proj_out."""
    tok = frames * pixels
    per_block = 2 * (4 * 2 * tok * dim * dim
                     + attention_flops(frames, dim, groups=pixels))
    per_block += 2 * tok * dim * 8 * dim + 2 * tok * 4 * dim * dim
    return 2 * 2 * tok * dim * dim + layers * per_block


def level_pixels(grid):
    gh, gw = grid
    return [int(gh * s) * int(gw * s) for s in SCALES]


def dpt_flops(dpt, embed_dim, grid, images, n_out=1, out_hw=None,
              temporal=None):
    """A DPT head over ``images`` images: projections, the 3 x 3 level
    convolutions, four fusions (residual units and 1 x 1 projections), the
    head's 3 x 3, 3 x 3 and 1 x 1 convolutions (the last at full
    resolution ``out_hw`` when ``temporal``), and with ``temporal`` (a dict
    of heads and layers) the four motion modules of Video Depth
    Anything."""
    f, ch = dpt["features"], dpt["out_channels"]
    gh, gw = grid
    px = level_pixels(grid)
    total = 0
    for i in range(4):
        total += 2 * gh * gw * embed_dim * ch[i]
        total += conv_flops(px[i], ch[i], f, 3)
    # fusion3: one residual unit; the others two; each a 1 x 1 projection
    total += 2 * conv_flops(px[3], f, f, 3) + conv_flops(px[2], f, f, 1)
    total += 4 * conv_flops(px[2], f, f, 3) + conv_flops(px[1], f, f, 1)
    total += 4 * conv_flops(px[1], f, f, 3) + conv_flops(px[0], f, f, 1)
    total += 4 * conv_flops(px[0], f, f, 3) + conv_flops(px[0], f, f, 1)
    total += conv_flops(px[0], f, f // 2, 3) + conv_flops(px[0], f // 2,
                                                         32, 3)
    if temporal is None:
        return images * (total + conv_flops(px[0], 32, n_out, 1))
    total += conv_flops(out_hw[0] * out_hw[1], 32, n_out, 1)
    total *= images
    layers = temporal.get("layers", 1)
    for pixels, dim in ((px[2], ch[2]), (px[3], ch[3]), (px[2], f),
                        (px[1], f)):
        total += temporal_flops(images, pixels, dim, layers)
    return total


def vda_windows(frames, window, overlap):
    """Start frames of the sliding windows over a shot."""
    starts = [0]
    while starts[-1] + window < frames:
        starts.append(starts[-1] + window - overlap)
    return starts


def vda_scene_flops(cfg, work_hw, frames):
    """Video Depth Anything over a shot: every window at its full length
    (the last padded with its last frame) through the ViT and the temporal
    head, and the metric anchor over the first frames."""
    e, vit = cfg["engine"], cfg["vit"]
    ps = vit["patch_size"]
    grid = (work_hw[0] // ps, work_hw[1] // ps)
    n_win = len(vda_windows(frames, e["window"], e["overlap"]))
    per_window = (vit_flops(vit, grid, e["window"])
                  + dpt_flops(cfg["dpt"], vit["embed_dim"], grid,
                              e["window"], out_hw=work_hw,
                              temporal=cfg["temporal"]))
    anchor = min(e["anchor_frames"], frames)
    a = cfg["anchor"]
    anchor_flops = (vit_flops(a["vit"], grid, anchor)
                    + dpt_flops(a["dpt"], a["vit"]["embed_dim"], grid,
                                anchor))
    return n_win * per_window + anchor_flops


def da3_window_views(frames, engine):
    """The views of each of a shot's DA3 windows."""
    ipb = engine["images_per_batch"]
    if frames <= ipb:
        return [frames]
    v = ipb + engine["num_ref_frames"] + engine["overlap"]
    step = ipb - engine["overlap"]
    n, start = 0, 0
    while True:
        n += 1
        if start + ipb >= frames:
            break
        start += step
    return [v] * n


def da3_scene_flops(cfg, work_hw, frames):
    """DA3 over a shot: each window's views through the ViT (cross-view
    blocks over the whole window) and the two heads (depth, 6-channel
    rays)."""
    vit = cfg["vit"]
    ps = vit["patch_size"]
    grid = (work_hw[0] // ps, work_hw[1] // ps)
    total = 0
    for v in da3_window_views(frames, cfg["engine"]):
        total += vit_flops(vit, grid, v, view_group=v)
        total += dpt_flops(cfg["dpt"], vit["embed_dim"], grid, v, n_out=1)
        total += dpt_flops(cfg["dpt"], vit["embed_dim"], grid, v, n_out=6)
    return total


def stereo_least_bytes(frames, h, w):
    """The stereo stage's least traffic: the RGB-coded depth and the colour
    read once, the side-by-side image and infill mask written once, all
    uint8."""
    return frames * h * w * (3 + 3 + 2 * 3 + 2 * 3)


# -- the disparity sweep's bytes and bound (frozen from chip_smoke.py) ------

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
F32_PER_TEST, F64_PER_TEST = 6, 2


def sweep_work(b, h, w, c, num_planes, ntiles, depth_cols_read,
               payload_cols_read, tests, hits):
    """(bytes, float32 ops, float64 ops) one sweep needs: the plane vectors
    (4 of (b, P)) and the activity bitmap (b, ntiles, P) read once; of the
    padded depth, the (element, row, column) places some test reads; of
    the payload, the places some hit blends, all C channels; every output
    (depth, C colours, found) written once. Operations: the tests up to
    each pixel's first hit and the blends of its hit."""
    nbytes = 4 * 4 * b * num_planes + 4 * b * ntiles * num_planes
    nbytes += b * h * w * (4 + 4 * c + 1)
    nbytes += 4 * depth_cols_read + 4 * c * payload_cols_read
    return (nbytes, F32_PER_TEST * tests + 2 * c * hits,
            F64_PER_TEST * tests + 2 * c * hits)


def bound_ms(nbytes, f32_ops, f64_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
