"""The operation and byte counts against numbers worked by hand."""

import json
from pathlib import Path

from counts import flops

HERE = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_bench_da3_cross_view_block():
    """One cross-view attention block of a 52-view window of 2,305 tokens
    (1024 wide): 4 * (52 * 2305)^2 * 1024 = 58.845 TFLOP."""
    ops = flops.attention_flops(52 * 2305, 1024)
    assert ops == 4 * 119860 ** 2 * 1024
    assert round(ops / 1e12, 3) == 58.845


def test_bench_da3_window_counts_cross_view_once_per_odd_block():
    cfg = config("da3_vitl")
    grid = (504 // 14, 896 // 14)
    assert grid[0] * grid[1] + 1 == 2305
    vit = cfg["vit"]
    one_window = flops.vit_flops(vit, grid, 52, view_group=52)
    per_view = flops.vit_flops(dict(vit, cross_view_indices=[]), grid, 52)
    extra = 12 * (flops.attention_flops(52 * 2305, 1024)
                  - 52 * flops.attention_flops(2305, 1024))
    assert one_window - per_view == extra
    # 12 cross-view blocks: 706.1 TFLOP of cross-view attention a window
    assert round(12 * flops.attention_flops(52 * 2305, 1024) / 1e12, 1) \
        == 706.1


def test_bench_vit_l_frame():
    """ViT-L/14 on a 518 x 924 frame (37 x 66 patches, 2,443 tokens):
    24 blocks of 24 N D^2 and 4 N^2 D, and the patch embedding."""
    vit = config("vda_vitl")["vit"]
    n, d = 37 * 66 + 1, 1024
    want = 24 * (24 * n * d * d + 4 * n * n * d) + 2 * 37 * 66 * d * 3 * 196
    assert flops.vit_flops(vit, (37, 66), 1) == want
    assert 2.0e12 < want < 2.1e12


def test_bench_da3_windows_of_the_film_shots():
    e = config("da3_vitl")["engine"]
    views = {t: flops.da3_window_views(t, e)
             for t in (18, 32, 46, 62, 83, 112, 160, 240)}
    assert views[18] == [18] and views[32] == [32]
    assert views[46] == [52, 52] and views[62] == [52, 52]
    assert views[240] == [52] * 7


def test_bench_vda_windows():
    assert flops.vda_windows(18, 32, 8) == [0]
    assert flops.vda_windows(62, 32, 8) == [0, 24, 48]
    assert len(flops.vda_windows(240, 32, 8)) == 10


def test_bench_b1_bytes_16_frame_eyes():
    """The sweep's bytes for 16 frame-eyes at 1080p, P = 128, 3 colour
    channels, 17 row tiles: the plane vectors (4 x 16 x 128 x 4 B) and the
    bitmap (16 x 17 x 128 x 4 B), the outputs (depth, 3 colours, found:
    17 B a pixel), and, where every test and hit reads every column, 4 B of
    depth and 12 B of colour a pixel: 1,095.03 MB. The chip_smoke scene's
    reads of about 94% of those places gave its 1,062.6 MB, which lies
    between the outputs alone and the full read."""
    b, h, w, c, p = 16, 1080, 1920, 3, 128
    px = b * h * w
    nbytes, f32, f64 = flops.sweep_work(b, h, w, c, p, 17, px, px, 0, 0)
    assert nbytes == 32768 + 139264 + 17 * px + 16 * px
    assert round(nbytes / 1e6, 2) == 1095.03
    outputs_only = flops.sweep_work(b, h, w, c, p, 17, 0, 0, 0, 0)[0]
    assert outputs_only / 1e6 < 1062.6 < nbytes / 1e6
    assert (f32, f64) == (0, 0)
    ms, by = flops.bound_ms(nbytes, 0, 0)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-9


def test_bench_stereo_least_bytes():
    """16 frames at 1080p: RGB depth and colour in (6 B a pixel), the SBS
    image and mask out (2 x 2 x 3 B a source pixel): 18 B a pixel."""
    assert flops.stereo_least_bytes(16, 1080, 1920) == 16 * 1080 * 1920 * 18


def test_bench_peaks_table():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("some other card") is None
