"""Port parity of the tracker and the streaming checkpoint:
doa_tpu_torch.tracking (its plain version, the kernel's CPU route) and
doa_tpu_torch.checkpoint against doa_tpu's on the same numpy inputs, on
the CPU."""

import numpy as np
import pytest
import torch

from doa_tpu import checkpoint as ckpt_jax
from doa_tpu import tracking as trk_jax
from doa_tpu.configs import PRESETS
from doa_tpu_torch import _build, checkpoint, plan, tracking
from doa_tpu_torch.io.synthetic import synth_moving_ula_iq
from doa_tpu_torch.ops.cuda import track as track_cuda
from doa_tpu_torch.pipeline_torch import build_pipeline_torch

TOL = 1e-4         # degrees, the port's tracks against the reference's


def _crossing():
    """tests/test_streaming_tracking.py's scene: two emitters crossing,
    shuffled detection order, clutter; values all equal."""
    B = 120
    t = np.arange(B)
    rng = np.random.default_rng(0)
    det = np.stack([50.0 + 0.3 * t + 0.3 * rng.standard_normal(B),
                    130.0 - 0.25 * t + 0.3 * rng.standard_normal(B)], 1)
    for b in range(B):
        if rng.random() < 0.5:
            det[b] = det[b, ::-1]
        if rng.random() < 0.05:
            det[b, rng.integers(2)] = rng.uniform(0, 180)
    return (det.astype(np.float32), np.ones_like(det, np.float32),
            trk_jax.TrackerConfig(max_tracks=4))


def _nan_scene():
    """Three emitters, K = 4 detections a window, a tenth of the angles
    and of the values NaN (a NaN angle wins its track's argmin and fails
    the gate; NaN values spawn last), tracks dying and respawning."""
    B, K = 150, 4
    rng = np.random.default_rng(1)
    t = np.arange(B)
    truth = np.stack([40 + 0.2 * t, 90 - 0.1 * t, 140 + 0 * t,
                      rng.uniform(0, 180, B)], 1)
    det = truth + 0.5 * rng.standard_normal((B, K))
    det[rng.random((B, K)) < 0.1] = np.nan
    det[60:70, 1] = np.nan                      # a track misses > 5
    val = rng.random((B, K))
    val[rng.random((B, K)) < 0.1] = np.nan
    return (det.astype(np.float32), val.astype(np.float32),
            trk_jax.TrackerConfig(max_tracks=3, gate_deg=4.0,
                                  max_missed=5, min_age=2))


def _tie_scene():
    """Values tied in every window (integer levels), detections ahead of
    the free slots and duplicated angles: the spawn order is the stable
    descending sort, the argmin's ties go to the first index."""
    B, K = 90, 6
    rng = np.random.default_rng(2)
    det = np.round(rng.uniform(20, 160, (B, K)) / 4) * 4
    det[:, 3] = det[:, 1]                       # equal costs
    val = rng.integers(0, 3, (B, K)).astype(np.float32)
    val[::7] = -0.0
    val[1::7] = 0.0
    return (det.astype(np.float32), val,
            trk_jax.TrackerConfig(max_tracks=5, gate_deg=6.0, alpha=0.3,
                                  beta=0.05, max_missed=2, min_age=1))


SCENES = {"crossing": _crossing, "nan": _nan_scene, "ties": _tie_scene}


def _tc(tc_jax) -> tracking.TrackerConfig:
    return tracking.TrackerConfig(**tc_jax.__dict__)


def _state_np(st):
    return [np.asarray(a) for a in st]


def _assert_same_tracks(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=TOL, equal_nan=True)


def _assert_same_state(got, want):
    g, w = _state_np(got), _state_np(want)
    for a, b in zip(g[:2], w[:2]):
        np.testing.assert_allclose(a, b, atol=TOL, equal_nan=True)
    for a, b in zip(g[2:], w[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene", list(SCENES))
def test_plain_tracker_matches_reference(scene):
    """track_batch_plain (the CPU route of track_batch) against
    doa_tpu.tracking.track_batch: tracks within 1e-4° with equal NaN
    masks, and the final states (angles and velocities within 1e-4, the
    masks and counters equal)."""
    det, val, tc = SCENES[scene]()
    want_state, want = trk_jax.track_batch(det, val, tc)
    init = tracking.init_tracks(_tc(tc), device="cpu")
    got_state, got = tracking.track_batch_plain(
        torch.from_numpy(det), torch.from_numpy(val), _tc(tc), init)
    assert got.dtype == torch.float32
    _assert_same_tracks(got, want)
    _assert_same_state(got_state, want_state)
    assert got_state.active.dtype == torch.bool
    assert got_state.missed.dtype == got_state.age.dtype == torch.int32
    # the public entry takes the same route on the CPU
    np.testing.assert_array_equal(
        tracking.track_batch_np(det, val, _tc(tc), device="cpu"),
        got.numpy())


def test_resume_from_reference_state_equals_uninterrupted():
    """A capture cut in two: the reference's state after the first part,
    turned into the port's (state_from_numpy), resumes the port's tracker
    on the second part with the tracks of the uninterrupted run; the
    port's own state resumes likewise."""
    det, val, tc = _nan_scene()
    cut = 70
    _, full = trk_jax.track_batch(det, val, tc)
    half_state, _ = trk_jax.track_batch(det[:cut], val[:cut], tc)
    st = tracking.state_from_numpy(_state_np(half_state), device="cpu")
    _, rest = tracking.track_batch(torch.from_numpy(det[cut:]),
                                   torch.from_numpy(val[cut:]), _tc(tc),
                                   init=st)
    _assert_same_tracks(rest, np.asarray(full)[cut:])
    own_half, _ = tracking.track_batch(det[:cut], val[:cut], _tc(tc),
                                       device="cpu")
    _, own_rest = tracking.track_batch(det[cut:], val[cut:], _tc(tc),
                                       init=own_half, device="cpu")
    _, own_full = tracking.track_batch(det, val, _tc(tc), device="cpu")
    assert torch.equal(own_rest.nan_to_num(), own_full[cut:].nan_to_num())
    assert torch.equal(own_rest.isnan(), own_full[cut:].isnan())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A stream checkpoint written by either package (the .npz keys and
    meta record are doa_tpu's) loads in the other, and its track state
    resumes the tracker as the uninterrupted run."""
    det, val, tc = _crossing()
    cut = 60
    _, full = trk_jax.track_batch(det, val, tc)
    tail = np.arange(8, dtype=np.complex64).reshape(4, 2)
    carry = np.ones((2, 2, 2), np.float32)
    path = str(tmp_path / "stream")                    # no extension
    if writer == "port":
        half, _ = tracking.track_batch(det[:cut], val[:cut], _tc(tc),
                                       device="cpu")
        checkpoint.save_stream_state(path, checkpoint.StreamState(
            track_state=half, samples_processed=cut * 512,
            overlap_tail=tail, cov_carry_re=carry, cov_carry_im=-carry))
        st = ckpt_jax.load_stream_state(path)
        _, rest = trk_jax.track_batch(det[cut:], val[cut:], tc,
                                      init=st.track_state)
    else:
        half, _ = trk_jax.track_batch(det[:cut], val[:cut], tc)
        ckpt_jax.save_stream_state(path, ckpt_jax.StreamState(
            track_state=half, samples_processed=cut * 512,
            overlap_tail=tail, cov_carry_re=carry, cov_carry_im=-carry))
        st = checkpoint.load_stream_state(path, device="cpu")
        assert st.track_state.angle.device.type == "cpu"
        _, rest = tracking.track_batch(det[cut:], val[cut:], _tc(tc),
                                       init=st.track_state, device="cpu")
    assert st.samples_processed == cut * 512 and st.version == 1
    np.testing.assert_array_equal(st.overlap_tail, tail)
    np.testing.assert_array_equal(st.cov_carry_im, -carry)
    _assert_same_tracks(rest, np.asarray(full)[cut:])


def test_checkpoint_without_tracks(tmp_path):
    p = str(tmp_path / "state_no_ext")
    checkpoint.save_stream_state(p, checkpoint.StreamState(
        samples_processed=77))
    st = checkpoint.load_stream_state(p, device="cpu")
    assert st.samples_processed == 77 and st.track_state is None
    assert ckpt_jax.load_stream_state(p).samples_processed == 77


def test_track_plan_routes():
    """plan.track_plan: the kernel where track_takes (1 ≤ max_tracks,
    K ≤ 32) on the card, the plain version on the CPU or past the
    kernel's lanes; Plan.op gives the wrapper or track_batch_plain."""
    p = plan.track_plan(4, 2)
    assert p == {"track": "track"}
    assert p.op("track") is track_cuda.track_scan
    assert plan.track_plan(4, 2, on_card=False) == {"track": "plain"}
    for M, K in ((33, 2), (4, 33), (4, 0)):
        assert not track_cuda.track_takes(M, K)
        assert plan.track_plan(M, K) == {"track": "plain"}
        assert plan.track_plan(M, K).op("track") is (
            tracking.track_batch_plain)
    assert track_cuda.track_takes(32, 32)
    # the CPU route of the wrapper is the plain version, and it counts
    # no launch
    det, val, tc = _crossing()
    init = tracking.init_tracks(_tc(tc), device="cpu")
    with _build.counting() as n:
        _, a = track_cuda.track_scan(torch.from_numpy(det),
                                     torch.from_numpy(val), _tc(tc), init)
    _, b = tracking.track_batch_plain(torch.from_numpy(det),
                                      torch.from_numpy(val), _tc(tc), init)
    assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert not n


def test_no_fallback_without_a_card(tmp_path):
    """init_tracks, state_from_numpy, load_stream_state, track_batch and
    track_batch_np on the card raise without one (never the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tc = tracking.TrackerConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.init_tracks(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.state_from_numpy(_state_np(tracking.init_tracks(
            tc, device="cpu")))
    p = str(tmp_path / "s.npz")
    checkpoint.save_stream_state(p, checkpoint.StreamState())
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_stream_state(p)
    det = np.zeros((3, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.track_batch(det, det, tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.track_batch_np(det, det, tc)


def test_c4_moving_emitters_end_to_end():
    """Config 4 on the CPU: moving-emitter IQ → the port's c4 pipeline →
    MUSIC peaks → the port's tracker; each trajectory followed by some
    track within 1.5° on average over the second half
    (tests/test_streaming_tracking.py's bound), and the port's tracks on
    the reference tracker's peaks equal the reference's."""
    cfg = PRESETS["c4_ula16_streaming"]
    T = 1 << 17
    x = synth_moving_ula_iq([(50.0, 80.0), (130.0, 100.0)], 16, 0.5, T,
                            snr_db=10, seed=5)
    res = build_pipeline_torch(cfg, device="cpu")(x)
    ang, val = res.peak_angles["music"], res.peak_values["music"]
    tc = tracking.TrackerConfig(max_tracks=4, gate_deg=4.0)
    _, tracks = tracking.track_batch(ang, val, tc)
    tracks = tracks.numpy()
    B = ang.shape[0]
    u = (np.arange(B) * cfg.hop + cfg.snapshot_size / 2) / T
    tail = slice(B // 2, None)
    for truth in (50.0 + 30.0 * u, 130.0 - 30.0 * u):
        errs = np.nanmin(np.abs(tracks[tail] - truth[tail, None]), axis=1)
        assert np.nanmean(errs) < 1.5, np.nanmean(errs)
    _, want = trk_jax.track_batch(ang.numpy(), val.numpy(),
                                  trk_jax.TrackerConfig(max_tracks=4,
                                                        gate_deg=4.0))
    _assert_same_tracks(tracks, want)
