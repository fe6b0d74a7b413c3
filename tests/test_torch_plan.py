"""The build-time kernel plan (doa_tpu_torch/plan.py: kernel_plan, which
pipeline_torch re-exports, and sharded_kernel_plan): which kernel each
stage launches on the card, and which stages take their plain torch
version because the kernel is not built for the config's shapes. The plan
is a pure function of the config, so it is pinned here without a card:
"plain" exactly where a wrapper's predicate rejects the shape, every
preset all-kernel, and each stage's callable the plan's. Then the shapes
that need the plain stages, through both packages on the CPU."""

import dataclasses

import numpy as np
import pytest

from doa_tpu.configs import (ArrayGeometry, DoaConfig, Estimator,
                             GridSpec1D, GridSpec2D, PRESETS, SmoothingSpec,
                             WidebandSpec)
from doa_tpu.io import SourceSpec, synth_ula_iq
from doa_tpu.pipeline_tpu import build_pipeline_tpu
from doa_tpu_torch.ops.cpx_ops import mgs_takes
from doa_tpu_torch.ops.cuda.cov_embedded import gram_takes
from doa_tpu_torch.ops.cuda.covariance import chunk_form, planes_takes
from doa_tpu_torch.ops.cuda.music_scan import (fma_takes, peaks_fma_takes,
                                               peaks_takes, peaks_tc_takes,
                                               scan_takes)
from doa_tpu_torch.ops.cuda.subspace_ns import ns_takes
from doa_tpu_torch import pipeline_torch
from doa_tpu_torch.ops.cuda import wideband_cov
from doa_tpu_torch.ops.cuda.wideband_cov import kernel_takes
from doa_tpu_torch.ops.cuda.wideband_scan import fusion_takes
from doa_tpu_torch.pipeline_torch import build_pipeline_torch, kernel_plan
from doa_tpu_torch.plan import (KERNELS, Plan, kernel_forms, kernel_routes,
                                sharded_kernel_plan, sharded_kernel_routes)


def _ula(N, K=2, S=1024, **kw):
    return DoaConfig(
        geometry=ArrayGeometry(kind="ula", num_elements=N, norm_spacing=0.5),
        snapshot_size=S, num_sources=K, estimators=(Estimator.MUSIC,),
        grid=GridSpec1D(num_points=256), num_max_vals=2, **kw)


def _ura10_wideband(fusion="incoherent"):
    """A 10x10 URA on c5's wideband path: N = 100, 2N = 200."""
    return DoaConfig(
        geometry=ArrayGeometry(kind="ura", num_elements=100, shape=(10, 10),
                               norm_spacing=0.5),
        snapshot_size=1024, num_sources=2, estimators=(Estimator.MUSIC,),
        grid2d=GridSpec2D(num_az=37, num_el=19), num_max_vals=2,
        wideband=WidebandSpec(num_subbands=16, fractional_bw=0.1,
                              fusion=fusion))


def _c5(**over):
    c5 = PRESETS["c5_ura64_wideband"]
    S = over.pop("snapshot_size", c5.snapshot_size)
    return dataclasses.replace(
        c5, snapshot_size=S,
        wideband=dataclasses.replace(c5.wideband, **over))


# (config, return_spectra) → the whole expected plan
_C5_SHAPES = {
    "ula17_planes": (lambda: _ula(17), True, {
        "covariance": "plain", "subspace": "mgs_iterate",
        "scan": "music_scan"}),
    "ula17_fused": (lambda: _ula(17, S=768), True, {
        "covariance": "plain", "covariance_planes": "plain",
        "subspace": "mgs_iterate", "scan": "music_scan"}),
    "ula48_spectra": (lambda: _ula(48), True, {
        "covariance": "plain", "covariance_planes": "plain",
        "subspace": "mgs_iterate", "scan": "music_scan"}),
    "ula48_peaks": (lambda: _ula(48), False, {
        "covariance": "plain", "covariance_planes": "plain",
        "subspace": "mgs_iterate", "scan": "music_scan_peaks"}),
    "ula16_k5_spectra": (lambda: _ula(16, K=5), True, {
        "covariance": "chunk_gram", "covariance_planes": "planes_chunk_gram",
        "subspace": "plain", "scan": "music_scan"}),
    "ula16_k5_peaks": (lambda: _ula(16, K=5), False, {
        "covariance": "chunk_gram", "covariance_planes": "planes_chunk_gram",
        "subspace": "plain", "scan": "music_scan_peaks"}),
    "ula16_k5_smoothed": (lambda: _ula(
        16, K=5, smoothing=SmoothingSpec(subarray_size=12)), True, {
        "covariance": "planes_chunk_gram", "subspace": "plain",
        "scan": "music_scan"}),
    "ula16_k5_ns": (lambda: _ula(16, K=5, subspace_impl="pallas"), True, {
        "covariance": "chunk_gram", "covariance_planes": "planes_chunk_gram",
        "subspace": "subspace_ns", "scan": "music_scan"}),
    "ula16_k8_ns": (lambda: _ula(16, K=8, subspace_impl="pallas"), True, {
        "covariance": "chunk_gram", "covariance_planes": "planes_chunk_gram",
        "subspace": "subspace_ns", "scan": "music_scan"}),
    "ura10_incoherent": (_ura10_wideband, True, {
        "covariance": "plain", "subspace": "plain",
        "fusion": "wideband_fusion", "peaks": "peaks2d"}),
    "ura10_cssm": (lambda: _ura10_wideband("cssm"), True, {
        "covariance": "plain", "subspace": "plain", "scan": "music_scan",
        "peaks": "peaks2d"}),
    "ura10_cssm_auto": (lambda: _ura10_wideband("cssm_auto"), True, {
        "covariance": "plain", "coarse_subspace": "plain",
        "subspace": "plain", "scan": "music_scan", "peaks": "peaks2d"}),
}


@pytest.mark.parametrize("name", list(_C5_SHAPES))
def test_plan_is_plain_exactly_where_a_predicate_says_no(name):
    make, spectra, want = _C5_SHAPES[name]
    assert kernel_plan(make(), return_spectra=spectra) == want


@pytest.mark.parametrize("pred,args,takes", [
    (gram_takes, (64,), True), (gram_takes, (30,), True),
    (gram_takes, (34,), False), (gram_takes, (66,), False),
    (gram_takes, (96,), False),
    (planes_takes, (32,), True), (planes_takes, (15,), True),
    (planes_takes, (17,), False), (planes_takes, (48,), False),
    (mgs_takes, (128, 8), True), (mgs_takes, (32, 10), False),
    (mgs_takes, (200, 4), False), (mgs_takes, (34, 4), True),
    (ns_takes, (128, 16), True), (ns_takes, (130, 4), False),
    (kernel_takes, (64,), True), (kernel_takes, (100,), False),
    (kernel_takes, (17,), False), (kernel_takes, (30,), True),
    (fusion_takes, (4, 224), True), (fusion_takes, (4, 240), False),
    (fusion_takes, (8, 448), True), (fusion_takes, (10, 32), False),
    (scan_takes, (4, 200), True), (scan_takes, (6, 24), True),
    (scan_takes, (10, 32), True), (scan_takes, (2, 240), True),
    (scan_takes, (16, 150), True), (scan_takes, (16, 152), False),
    (fma_takes, (10, 32), True), (fma_takes, (4, 300), True),
    (fma_takes, (2, 360), True), (fma_takes, (2, 364), False),
])
def test_predicates_at_their_edges(pred, args, takes):
    assert pred(*args) is takes


@pytest.mark.parametrize("pred,args,takes", [
    (peaks_tc_takes, (4, 32, 1024), True),
    (peaks_tc_takes, (4, 32, 1025), False),
    (peaks_tc_takes, (6, 24, 1280), True),
    (peaks_tc_takes, (6, 24, 1281), False),
    (peaks_tc_takes, (4, 16, 181), True), (peaks_tc_takes, (2, 8, 3), True),
    (peaks_tc_takes, (2, 8, 2), False), (peaks_tc_takes, (10, 32, 64), False),
    (peaks_tc_takes, (4, 240, 64), False),
    (peaks_fma_takes, (10, 32, 1024), True),
    (peaks_fma_takes, (4, 32, 8192), True),
    (peaks_fma_takes, (4, 32, 8193), False),
    (peaks_fma_takes, (16, 3504, 1024), True),
    (peaks_fma_takes, (16, 3505, 1024), False),
    (peaks_fma_takes, (4, 32, 2), False),
    (peaks_takes, (4, 32, 1025), True), (peaks_takes, (10, 32, 8192), True),
    (peaks_takes, (16, 3505, 1024), False),
    (peaks_takes, (4, 32, 8193), False),
])
def test_peaks_predicates_at_their_edges(pred, args, takes):
    """K2's two forms: the tensor-core form where the mainloop takes
    (2K, 2N) and the den tile of 32 × G bins, the ring, V' and nrm fit a
    block's shared memory; the CUDA-core form for 2K of 10 to 16 and G up
    to MAX_FUSED_G; peaks_takes their union."""
    assert pred(*args) is takes


def _k2_shape(cfg):
    return (2 * cfg.num_sources, 2 * cfg.effective_num_elements,
            cfg.grid.num_points)


def _k2_form(cfg):
    routes = kernel_routes(cfg, return_spectra=False)
    return Plan(routes, forms=kernel_forms(cfg, routes)).forms["scan"]


def test_every_preset_k2_stage_takes_the_tensor_core_form():
    """Every preset whose plan runs K2 (return_spectra=False, 1-D grid)
    takes K2's tensor-core form, on one card and sharded; the shapes no
    preset has take its CUDA-core form: ULA-16 at K = 5 (2K = 10) and a
    grid past the den tile (G = 2048 at the headline's widths). The plan
    names the form ("tc", "fma")."""
    fused = []
    for name, cfg in sorted(PRESETS.items()):
        if kernel_plan(cfg, return_spectra=False).get("scan") != (
                "music_scan_peaks"):
            continue
        fused.append(name)
        assert peaks_tc_takes(*_k2_shape(cfg)), name
        assert _k2_form(cfg) == "tc", name
    assert {"c1_ula4_tone", "c2_ula8_2src", "c3_ula16_calib_smooth",
            "c4_ula16_streaming", "fast_bf16", "fast_int8"} <= set(fused)
    for cfg in (_ula(16, K=5), dataclasses.replace(
            _ula(16), grid=GridSpec1D(num_points=2048))):
        shape = _k2_shape(cfg)
        assert not peaks_tc_takes(*shape) and peaks_fma_takes(*shape)
        assert _k2_form(cfg) == "fma"
        assert kernel_plan(cfg, return_spectra=False)["scan"] == (
            "music_scan_peaks")
        assert sharded_kernel_plan(cfg, 2, 1, False)["scan"] == (
            "music_scan_peaks")


_CSSM_PATHS = {"c5_f12": lambda: _c5(num_subbands=12, snapshot_size=768),
               "c5_cssm": lambda: _c5(fusion="cssm"),
               "c5_cssm_auto": lambda: _c5(fusion="cssm_auto")}


@pytest.mark.parametrize("spectra", [True, False])
@pytest.mark.parametrize("name", sorted(PRESETS) + list(_CSSM_PATHS))
def test_every_preset_plans_a_kernel_for_every_stage(name, spectra):
    cfg = PRESETS[name] if name in PRESETS else _CSSM_PATHS[name]()
    plan = kernel_plan(cfg, return_spectra=spectra)
    assert "covariance" in plan and "subspace" in plan
    assert "plain" not in plan.values(), plan


_NARROWBAND = ["c1_ula4_tone", "c2_ula8_2src", "c3_ula16_calib_smooth",
               "c4_ula16_streaming", "fast_bf16", "fast_int8"]


@pytest.mark.parametrize("spectra", [True, False])
@pytest.mark.parametrize("name", _NARROWBAND)
def test_every_preset_names_kernel_8_forms(name, spectra):
    """Kernel 8 runs on every narrowband preset: for its planes on the
    planes route ("covariance") or for planes input on the fused route
    ("covariance_planes"). The plan names the form it takes on the views
    of a complex64 capture, the ring mainloop, one card and sharded
    alike (beside the forms of the other stages' kernels, K4's). On the
    CPU no stage runs a kernel, so no form is named."""
    cfg = PRESETS[name]
    N = cfg.geometry.num_elements
    want = "ring_interleaved"
    routes = kernel_routes(cfg, return_spectra=spectra)
    plan = Plan(routes, forms=kernel_forms(cfg, routes))
    stages = [st for st in ("covariance", "covariance_planes")
              if plan.get(st) == "planes_chunk_gram"]
    assert stages, dict(plan)
    k8 = {st: f for st, f in plan.forms.items()
          if plan[st] == "planes_chunk_gram"}
    assert k8 == {st: want for st in stages}
    assert chunk_form(N, "interleaved") == want
    sh = sharded_kernel_routes(cfg, 2, 1, spectra)
    splan = Plan(sh, forms=kernel_forms(cfg, sh))
    assert {st: f for st, f in splan.forms.items()
            if splan[st] == "planes_chunk_gram"} == {
                st: want for st, k in splan.items()
                if k == "planes_chunk_gram"}
    assert Plan(routes, on_card=False,
                forms=kernel_forms(cfg, routes)).forms == {}
    assert build_pipeline_torch(cfg, device="cpu").plan.forms == {}


@pytest.mark.parametrize("name", _NARROWBAND)
def test_every_preset_plans_kernels_sharded(name):
    cfg = dataclasses.replace(PRESETS[name], halo_impl="pallas")
    plan = sharded_kernel_plan(cfg, 2, 1, return_spectra=False)
    assert "plain" not in plan.values(), plan
    assert plan["subspace"] == "mgs_iterate"
    assert ("halo" in plan) == (cfg.overlap > 0)


def test_sharded_plan_follows_the_predicates():
    assert sharded_kernel_plan(_ula(48), 2, 1) == {
        "covariance": "plain", "subspace": "mgs_iterate",
        "scan": "music_scan"}
    assert sharded_kernel_plan(_ula(16, K=5), 2, 2, False) == {
        "covariance": "chunk_gram", "subspace": "plain",
        "scan": "music_scan"}
    assert sharded_kernel_plan(_ula(16, K=5), 2, 1, False)["scan"] == (
        "music_scan_peaks")


@pytest.mark.parametrize("fusion,spec,want", [
    ("incoherent", (1, 2), {"covariance": "wideband_fft_gram",
                            "subspace": "mgs_iterate",
                            "fusion": "wideband_fusion", "peaks": "peaks2d"}),
    ("tops", (1, 2), {"covariance": "wideband_fft_gram", "peaks": "peaks2d"}),
    ("cssm", (2, 1), {"covariance": "wideband_fft_gram",
                      "subspace": "mgs_iterate", "scan": "music_scan"}),
    ("cssm_auto", (2, 1), {"covariance": "wideband_fft_gram",
                           "coarse_subspace": "mgs_iterate",
                           "subspace": "mgs_iterate", "scan": "music_scan"}),
])
def test_sharded_wideband_plans_the_ep_kernels(fusion, spec, want):
    """c5's EP builders plan a kernel for every stage: kernel 4 on each
    rank's block (F = 16, a power of two), K4, kernel 5 on the rank's
    subbands and kernel 6 on the whole row (incoherent), kernel 4 and 6
    (TOPS), K4 and K3 for R_coh's scan, whose grid (16471 points) takes
    the O(k) merge unsharded, no kernel 6 (CSSM). At F = 12 (not a power
    of two) the front end is the single card's: kernel 4's frames source,
    and kernel 5 still fuses each rank's subbands."""
    assert sharded_kernel_plan(_c5(fusion=fusion), *spec) == want
    f12 = _c5(num_subbands=12, snapshot_size=768)
    assert sharded_kernel_plan(f12, 1, 2) == {
        "covariance": "subband_embedded_frames", "subspace": "mgs_iterate",
        "fusion": "wideband_fusion", "peaks": "peaks2d"}
    assert (sharded_kernel_plan(f12, 1, 2)["covariance"]
            == kernel_plan(f12)["covariance"])


def test_k3_keeps_a_kernel_for_every_shape_its_first_form_took():
    """K3's CUDA-core form took any 2K wherever its tiles fit shared
    memory; scan_takes keeps all of those (the tensor-core form, else the
    CUDA-core form) and K3's plan never says "plain" there."""
    for k2 in range(2, 17, 2):
        for n2 in range(2, 161, 2):
            first_form = 4 * n2 * (128 + 16 * k2) <= 232448
            assert scan_takes(k2, n2) or not first_form, (k2, n2)


_ROUTE_CONFIGS = {
    "ula48": lambda: _ula(48), "ula16_k5": lambda: _ula(16, K=5),
    "ula16_k5_ns": lambda: _ula(16, K=5, subspace_impl="pallas"),
    "ura10_cssm_auto": lambda: _ura10_wideband("cssm_auto"),
    "ura10_incoherent": _ura10_wideband,
    "c5_f12": lambda: _c5(num_subbands=12, snapshot_size=768)}


@pytest.mark.parametrize("name", list(_ROUTE_CONFIGS))
def test_plan_ops_are_the_kernels_or_their_plain_versions(name):
    """Plan.op gives each stage its kernel's wrapper where planned and the
    kernel's plain version where the plan (or the CPU) says "plain"; the
    sharded routes name kernels of the same table."""
    cfg = _ROUTE_CONFIGS[name]()
    for on_card in (True, False):
        plan = Plan(kernel_routes(cfg), on_card=on_card)
        for stage, kernel in plan.kernels.items():
            wrapper, plain = KERNELS[kernel]
            want = "plain" if not on_card else kernel_plan(cfg)[stage]
            assert plan[stage] == want
            assert plan.op(stage) is (plain if want == "plain"
                                      else wrapper)
    if not cfg.wideband.enabled:
        for stage, (kernel, _) in sharded_kernel_routes(cfg, 2, 1).items():
            assert kernel in KERNELS or stage == "halo"


@pytest.mark.parametrize("F", [6, 10, 12])
def test_non_power_of_two_front_end_plans_the_frames_launch(F, monkeypatch):
    """At F not a power of two the covariance stage is the ring kernel's
    launch on the frames ("subband_embedded_frames", the "embedded"
    variant's stage), whose plain version is the reference's channelizer
    + kernel 7; no stage names kernel 7's stream entry, and building the
    pipeline builds no channelizer matrix."""
    cfg = _c5(num_subbands=F, snapshot_size=64 * F)
    plan = Plan(kernel_routes(cfg))
    assert plan["covariance"] == "subband_embedded_frames"
    assert plan.op("covariance") is wideband_cov.subband_embedded_frames
    assert Plan(kernel_routes(cfg), on_card=False).op("covariance") is (
        wideband_cov.subband_embedded_frames_plain)
    assert "subband_embedded" not in plan.values()
    assert "subband_embedded" not in KERNELS

    def no_channelizer(*a, **k):
        raise AssertionError("the pipeline built a channelizer matrix")
    monkeypatch.setattr(wideband_cov, "channelizer_matrix", no_channelizer)
    monkeypatch.setattr(pipeline_torch, "channelizer_matrix", no_channelizer,
                        raising=False)
    pipe = build_pipeline_torch(cfg, device="cpu")
    assert pipe.plan["covariance"] == "plain"


@pytest.mark.parametrize("name", ["c2_ula8_2src", "c3_ula16_calib_smooth",
                                  "c5_ura64_wideband"])
def test_cpu_pipeline_plans_every_stage_plain(name):
    """On the CPU every stage runs its plain version; call.plan keeps the
    card plan's stages."""
    pipe = build_pipeline_torch(PRESETS[name], device="cpu")
    assert set(pipe.plan) == set(kernel_plan(PRESETS[name]))
    assert set(pipe.plan.values()) == {"plain"}


def _capture(N, thetas, B, S, seed):
    return synth_ula_iq([SourceSpec(theta_deg=t, freq_norm=0.05 + 0.08 * i)
                         for i, t in enumerate(thetas)],
                        N, 0.5, B * S, snr_db=15,
                        seed=seed).astype(np.complex64)


@pytest.mark.parametrize("N,thetas,spectra", [
    (48, (60.0, 110.0), True),
    (16, (30.0, 55.0, 80.0, 105.0, 135.0), False)])
def test_plain_stage_shapes_match_reference(N, thetas, spectra):
    """ULA-48 (K1 plain on the card; K3 here) and ULA-16 at K = 5 (K4 plain
    on the card; K2 here) on the fused route: the same angles as doa_tpu's
    pipeline with its Pallas kernels in interpret mode, within 1e-3°, and
    equal escalation counts."""
    S = 256
    cfg = dataclasses.replace(_ula(N, K=len(thetas), S=S),
                              num_max_vals=len(thetas))
    x = _capture(N, thetas, 34, S, seed=N)
    ref = build_pipeline_tpu(dataclasses.replace(
        cfg, cov_impl="pallas", scan_mode="pallas"),
        return_spectra=spectra)(x)
    out = build_pipeline_torch(cfg, device="cpu", return_spectra=spectra)(x)
    a = out.peak_angles["music"].numpy()
    a_ref = np.asarray(ref.peak_angles["music"])
    assert a.shape == a_ref.shape == (34, len(thetas))
    np.testing.assert_allclose(a, a_ref, atol=1e-3)
    assert int(out.escalation_flagged) == int(ref.escalation_flagged)
    assert np.abs(np.sort(a, -1) - np.array(thetas)).max() < 1.0


@pytest.mark.parametrize("name,form", [
    ("c1_ula4_tone", "embedded"), ("c2_ula8_2src", "embedded"),
    ("c4_ula16_streaming", "windows"), ("fast_bf16", "embedded"),
    ("fast_int8", "gram")])
def test_the_covariance_stage_keeps_its_name_and_names_its_epilogue(name,
                                                                     form):
    """The fused route's covariance stage is K1's "chunk_gram" on one card
    and sharded, whichever epilogue it launches; the plan's form names the
    epilogue (chunk_grams_uhat counts ("chunk_gram", it)): kernel 9's
    "embedded" where a window is one chunk and the capture is float32 or
    bfloat16, its "windows" entry where windows overlap (c4: g = 512, two
    chunks a window), K1's "gram" for int8 ingest. On the CPU no form is
    named."""
    cfg = PRESETS[name]
    routes = kernel_routes(cfg)
    assert routes["covariance"][0] == "chunk_gram"
    plan = Plan(routes, forms=kernel_forms(cfg, routes))
    assert plan["covariance"] == plan.kernels["covariance"] == "chunk_gram"
    assert plan.forms["covariance"] == form
    sh = sharded_kernel_routes(cfg, 2, 1, True)
    splan = Plan(sh, forms=kernel_forms(cfg, sh))
    assert splan["covariance"] == "chunk_gram"
    assert splan.forms["covariance"] == form
    assert "covariance" not in build_pipeline_torch(
        cfg, device="cpu").plan.forms
