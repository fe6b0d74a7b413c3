"""On the card: the covariance stage's embedded epilogue (kernel 9's entry
in K1's place where a window is one chunk) against K1 followed by the
torch fold, bit for bit, its window epilogue (kernel 9's window entry
where windows overlap) against kernel 9's per-chunk E summed in chunk
order, bit for bit, and kernel 9's other uses. Every test skips
without an NVIDIA GPU. This file imports no JAX, so it runs on a machine
with the card and without JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m card -q \\
        tests/test_torch_cov_embedded_card.py
"""

import math
import os
import re

import pytest
import torch

from doa_tpu_torch import _build
from doa_tpu_torch.ops.cuda import cov_embedded as ce

pytestmark = pytest.mark.card

WIDTHS = (6, 16, 30, 32, 64)        # both register-tile forms of K1

with open(os.path.join(_build.CSRC, "gram_ring.cuh")) as _f:
    _HEADER = _f.read()
THREADS, STAGE_BYTES = (
    int(re.search(rf"constexpr int {k} = (\d+);", _HEADER).group(1))
    for k in ("THREADS", "STAGE_BYTES"))


def k1_takes_whole_chunks(n2, g, itemsize):
    """gram_ring.cuh's whole_chunks: K1's row classes take whole chunks
    where a stage holds a chunk for every class; kernel 9's entry then
    runs K1's form and folds in place (fold_kernel), else its own
    epilogue (chunk_embedded_kernel)."""
    rt = 4 if n2 % 4 == 0 and n2 <= 64 else 2
    ntri = (n2 // rt) * (n2 // rt + 1) // 2
    return g * (THREADS // ntri) <= (STAGE_BYTES // (n2 * itemsize)) & ~15


COV_GRAM_KERNELS = ("chunk_gram_kernel", "chunk_embedded_kernel",
                    "chunk_windows_kernel", "fold_kernel")  # cov_gram.cu's


def card_kernels(fn, every=False):
    """fn() → (its result, {kernel name: launches} of csrc/cov_gram.cu's
    kernels on the card, or of every kernel with every=True)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n = e.name.replace("(anonymous namespace)::", "")
            n = re.split(r"[<(]", n.removeprefix("void "), maxsplit=1)[0]
            n = n.split("::")[-1].strip()
            if every or n in COV_GRAM_KERNELS:
                names[n] = names.get(n, 0) + 1
    return out, names


def cov_gram_launches(n):
    """The launches of csrc/cov_gram.cu's wrappers (the covariance
    stage's "chunk_gram", kernel 9's "chunk_embedded") in a
    _build.counting() block's counts."""
    return {k: v for k, v in n.items()
            if k[0] in ("chunk_gram", "chunk_embedded")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _correction(N, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.polar(1.0 + 0.1 * torch.randn(N, generator=gen, device=dev),
                    0.3 * torch.randn(N, generator=gen, device=dev))
    return c.real.contiguous(), c.imag.contiguous()


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n2", WIDTHS)
def test_route_E_is_k1_then_the_fold(dev, n2, dtype, fb, S):
    """cov_embedded at overlap 0 (g = S) gives E bit for bit as K1's
    Grams folded by uhat_windows_to_embedded, with a correction, FB on
    and off, through kernel 9's entry (gram_epilogue's "embedded",
    counted as ("chunk_gram", "embedded"); K1's "gram" does not move):
    its epilogue where K1 shares each chunk across its row classes (every
    width at S = 1024), K1's whole-chunk form and the in-place fold where
    K1 takes whole chunks (some widths at S = 64)."""
    N = n2 // 2
    n = 300 if S == 1024 else 2000
    gen = torch.Generator(device=dev).manual_seed(n2 * 1000 + S + fb)
    x = torch.randn((n * S + 17, n2), generator=gen, device=dev)
    cr, ci = _correction(N, dev, n2)
    dt = ce._DTYPES[dtype]
    with _build.counting() as launched:
        E, ran = card_kernels(lambda: ce.cov_embedded(
            x, cr, ci, N=N, snapshot_size=S, fb=fb, compute_dtype=dtype))
    assert ce.gram_epilogue(dt) == "embedded"
    assert launched == {("chunk_gram", "embedded"): 1}
    if k1_takes_whole_chunks(n2, S, dt.itemsize):
        assert ran == {"chunk_gram_kernel": 1, "fold_kernel": 1}, ran
    else:
        assert ran == {"chunk_embedded_kernel": 1}, ran
    U = ce.chunk_grams_uhat(x.to(dt), S)
    ref = ce.uhat_windows_to_embedded(U, N, 1.0 / S,
                                      ce.correction_pattern(cr, ci), fb)
    assert E.shape == ref.shape == (n, n2, n2)
    assert torch.equal(_bits(E), _bits(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n2", WIDTHS)
def test_chunk_variant_below_a_window(dev, n2, dtype):
    """Kernel 9 where a window spans chunks (the "chunk" variant's g < S):
    bit for bit K1 + the fold on each chunk of 512 rows, and exact against
    its plain version on integer samples in chunks of 7 rows."""
    N = n2 // 2
    gen = torch.Generator(device=dev).manual_seed(n2)
    cr, ci = _correction(N, dev, n2 + 1)
    W = ce.correction_pattern(cr, ci)
    x = torch.randn((400 * 512, n2), generator=gen, device=dev).to(dtype)
    for fb in (False, True):
        Ek = ce.chunk_embedded(x, 512, N, 1.0 / 1024, W, fb)
        ref = ce.uhat_windows_to_embedded(ce.chunk_grams_uhat(x, 512), N,
                                          1.0 / 1024, W, fb)
        assert torch.equal(_bits(Ek), _bits(ref))
    # integer samples |x| <= 8 (exact in bf16), an integer correction and
    # scale 1/16: every sum, fold and product exact in FP32
    xi = torch.randint(-8, 9, (700 * 7 + 1, n2), generator=gen,
                       device=dev).to(dtype)
    Wi = ce.correction_pattern(
        torch.randint(-1, 3, (N,), generator=gen, device=dev).float(),
        torch.randint(-1, 2, (N,), generator=gen, device=dev).float())
    for fb in (False, True):
        d = (ce.chunk_embedded(xi, 7, N, 1.0 / 16, Wi, fb)
             - ce.chunk_embedded_plain(xi, 7, N, 1.0 / 16, Wi, fb))
        assert d.abs().max().item() == 0.0


def test_the_headline_launches_the_embedded_epilogue_once(dev):
    """A fused c2 call (ULA-8, overlap 0): the covariance stage launches
    kernel 9's entry once ("embedded", its own epilogue) and K1 not at
    all; the plan names the epilogue."""
    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    cfg = PRESETS["c2_ula8_2src"]
    call = build_pipeline_torch(cfg, device=dev, return_spectra=False)
    assert call.plan.forms["covariance"] == "embedded"
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((64 * cfg.snapshot_size, 16), generator=gen, device=dev)
    call.interleaved(x)
    torch.cuda.synchronize()
    with _build.counting() as launched:
        _, ran = card_kernels(lambda: call.interleaved(x))
    assert cov_gram_launches(launched) == {("chunk_gram", "embedded"): 1}
    assert ran == {"chunk_embedded_kernel": 1}, ran


def _ordered(E, windows):
    return ce.ordered_window_sums(E, *windows)


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["c4", "ragged n_win 4", "ragged stride 3"])
def test_window_entry_is_kernel_9s_chunks_summed_in_order(dev, shape,
                                                          dtype, fb):
    """Kernel 9's window entry (the stage with embed and windows, where
    gram_epilogue names "windows") gives each window's E bit for bit as
    kernel 9's per-chunk entry followed by the ordered torch sum
    (ordered_window_sums), with a correction, FB off and on: at c4's shape
    (2^24 samples, S = 1024, hop 512: g = 512, n_win 2) and on chunk
    counts that split unevenly over the persistent grid (S = 1024, hop
    256: n_win 4, stride 1; hop 768: n_win 4, stride 3). One launch of
    its kernel, counted as ("chunk_gram", "windows"); K1 does not run,
    and cov_embedded at that overlap launches the window entry alone,
    with the same E."""
    S, hop, T = {"c4": (1024, 512, 1 << 24),
                 "ragged n_win 4": (1024, 256, 5003 * 256 + 77),
                 "ragged stride 3": (1024, 768, 4001 * 256 + 5)}[shape]
    N = 16
    g = math.gcd(S, hop)
    n_win, stride = S // g, hop // g
    B = (T - S) // hop + 1
    windows = (B, n_win, stride)
    assert ce.gram_epilogue(dtype, 2 * N, n_win, stride) == "windows"
    assert not k1_takes_whole_chunks(2 * N, g, dtype.itemsize)
    gen = torch.Generator(device=dev).manual_seed(T + fb)
    x = torch.randn((T, 2 * N), generator=gen, device=dev).to(dtype)
    cr_ci = _correction(N, dev, 7)
    W = ce.correction_pattern(*cr_ci)
    embed = (N, 1.0 / S, W, fb)
    with _build.counting() as launched:
        E = ce.chunk_grams_uhat(x, g, embed, windows)
    assert launched == {("chunk_gram", "windows"): 1}
    n = (B - 1) * stride + n_win
    ref = _ordered(ce.chunk_embedded(x[:n * g], g, N, 1.0 / S, W, fb),
                   windows)
    assert E.shape == ref.shape == (B, 2 * N, 2 * N)
    assert torch.equal(_bits(E), _bits(ref))
    # the stacked variant at this overlap: the window entry alone
    Es, ran = card_kernels(lambda: ce.cov_embedded(
        x, *cr_ci, N=N, snapshot_size=S, overlap=S - hop, fb=fb,
        compute_dtype=dtype))
    assert ran == {"chunk_windows_kernel": 1}, ran
    assert torch.equal(_bits(Es), _bits(E))


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_entry_takes_k1s_whole_chunk_shapes(dev, dtype, fb):
    """At a g where K1 takes whole chunks (S = 256, overlap 100: g = 4,
    n_win 64, stride 39) the window entry still shares each chunk over its
    classes: the stage launches it once (("chunk_gram", "windows"); K1
    never), cov_embedded at that overlap runs its kernel alone with the
    same E, and each window lies within 1e-5·max|E| of the plain version
    (chunk_windows_plain) and of kernel 9's per-chunk E summed in order
    (K1's whole-chunk form adds a chunk's rows in another order, so not
    bit for bit). The profiler is read on
    cov_embedded's call, whose torch ops surround the launch: on a region
    holding the ctypes launch alone it missed the kernel in most tries
    (H100, torch's CUPTI tracing)."""
    S, hop, N = 256, 156, 16
    g = math.gcd(S, hop)
    n_win, stride = S // g, hop // g
    T = 4000 * hop + 91
    B = (T - S) // hop + 1
    windows = (B, n_win, stride)
    assert k1_takes_whole_chunks(2 * N, g, dtype.itemsize)
    assert ce.gram_epilogue(dtype, 2 * N, n_win, stride) == "windows"
    gen = torch.Generator(device=dev).manual_seed(T + fb)
    x = torch.randn((T, 2 * N), generator=gen, device=dev).to(dtype)
    cr_ci = _correction(N, dev, 8)
    W = ce.correction_pattern(*cr_ci)
    embed = (N, 1.0 / S, W, fb)
    with _build.counting() as launched:
        E = ce.chunk_grams_uhat(x, g, embed, windows)
    assert launched == {("chunk_gram", "windows"): 1}
    Es, ran = card_kernels(lambda: ce.cov_embedded(
        x, *cr_ci, N=N, snapshot_size=S, overlap=S - hop, fb=fb,
        compute_dtype=dtype))
    assert ran == {"chunk_windows_kernel": 1}, ran
    assert torch.equal(_bits(Es), _bits(E))
    n = (B - 1) * stride + n_win
    plain = ce.chunk_windows_plain(x, g, *embed, windows)
    summed = _ordered(ce.chunk_embedded(x[:n * g], g, *embed), windows)
    scale = plain.abs().max().item()
    for ref in (plain, summed):
        assert (E - ref).abs().max().item() <= 1e-5 * scale


def test_the_hop512_call_launches_the_window_entry_once(dev):
    """A fused call at hop 512 (c4: ULA-16, S = 1024, overlap 512, the
    benchmark's hop512 traffic): the plan names the "windows" epilogue,
    the covariance stage launches kernel 9's window entry once and K1 not
    at all, and no prefix sum (torch.cumsum's scan_outer_dim kernel) runs
    in the call; at hop 1024 the same array keeps kernel 9's "embedded"
    entry."""
    import dataclasses

    from doa_tpu_torch import PRESETS
    from doa_tpu_torch.pipeline_torch import build_pipeline_torch

    c4 = PRESETS["c4_ula16_streaming"]
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((256 * 1024, 32), generator=gen, device=dev)
    for cfg, form, kernel in (
            (c4, "windows", "chunk_windows_kernel"),
            (dataclasses.replace(c4, overlap=0), "embedded",
             "chunk_embedded_kernel")):
        call = build_pipeline_torch(cfg, device=dev, return_spectra=False)
        assert call.plan.forms["covariance"] == form
        call.interleaved(x)
        torch.cuda.synchronize()
        with _build.counting() as launched:
            _, ran = card_kernels(lambda: call.interleaved(x), every=True)
        assert cov_gram_launches(launched) == {("chunk_gram", form): 1}
        assert ran.get(kernel) == 1, ran
        assert not {"chunk_gram_kernel", "fold_kernel"} & set(ran), ran
        assert not [n for n in ran if "scan_outer_dim" in n], ran
