"""The per-layer metrics' work functions against the bounds PERF.md §6
gives at its shapes (H100 SXM peaks: 3.35 TB/s, FP32 67 TFLOP/s, TF32 495
TFLOP/s): K1 f32 0.6611 ms at the headline, kernel 4 0.9616 ms and kernel
5's TF32 products 3.3495 ms at c5, K2's 0.0260 ms at the headline."""

import pytest

from harness.roofline import BYTES_PER_S, RATES, bound_s
from harness.shapes import cell_shapes
from harness.spec import BENCH_DIR, Cell, load_metric


def _shapes(spec, cell, T):
    return cell_shapes(Cell(spec, cell).fields, T)


def test_k1_bound_at_the_headline(spec):
    s = _shapes(spec, "ula16_music.hop1024", 1 << 24)
    w = load_metric("covariance_roofline").work(s)
    assert w["bytes"] / BYTES_PER_S * 1e3 == pytest.approx(0.6611, abs=5e-5)
    assert bound_s(w) * 1e3 == pytest.approx(0.6611, abs=5e-5)


def test_kernel4_bound_at_c5(spec):
    s = _shapes(spec, "ura64_wideband.survey", 1 << 21)
    assert (s["M"], s["F"], s["g"], s["chunks"]) == (131072, 16, 64, 2048)
    w = load_metric("wb_front_roofline").work(s)
    assert bound_s(w) * 1e3 == pytest.approx(0.9616, abs=5e-5)


def test_kernel5_tf32_products_at_c5(spec):
    s = _shapes(spec, "ura64_wideband.survey", 1 << 21)
    w = load_metric("wb_fusion_roofline").work(s)
    t = w["ops"]["tf32x3"] / RATES["tf32x3"] * 1e3
    assert t == pytest.approx(3.3495, abs=5e-5)
    assert bound_s(w) * 1e3 > t          # its FP32 work comes on top


def test_k2_tf32_products_at_the_headline(spec):
    s = _shapes(spec, "ula16_music.hop1024", 1 << 24)
    w = load_metric("scan_roofline").work(s)
    assert w["ops"]["tf32x3"] / RATES["tf32x3"] * 1e3 == pytest.approx(
        0.0260, abs=5e-5)


@pytest.mark.parametrize("name", ["covariance_roofline", "subspace_roofline",
                                  "scan_roofline", "wb_front_roofline",
                                  "wb_fusion_roofline"])
def test_work_grows_with_the_call(spec, name):
    cell = ("ura64_wideband.survey" if name.startswith("wb_")
            else "ula16_music.hop1024")
    T = 1 << (21 if cell.startswith("ura") else 25)
    small = bound_s(load_metric(name).work(_shapes(spec, cell, T // 2)))
    big = bound_s(load_metric(name).work(_shapes(spec, cell, T)))
    assert big == pytest.approx(2 * small, rel=0.02)
    assert (BENCH_DIR / "metrics" / f"{name}.py").exists()
