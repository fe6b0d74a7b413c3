"""On the card: the covariance stage's embedded epilogue (kernel 9's entry
in K1's place where a window is one chunk) against K1 followed by the
torch fold, bit for bit, and kernel 9's other uses. Every test skips
without an NVIDIA GPU. This file imports no JAX, so it runs on a machine
with the card and without JAX, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m card -q \\
        tests/test_torch_cov_embedded_card.py
"""

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
                    "fold_kernel")             # csrc/cov_gram.cu's


def card_kernels(fn):
    """fn() → (its result, {kernel name: launches} of csrc/cov_gram.cu's
    kernels on the card)."""
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
            if n in COV_GRAM_KERNELS:
                names[n] = names.get(n, 0) + 1
    return out, names


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
    counted by chunk_grams_uhat.by_epilogue and chunk_embedded.launches;
    K1's own count does not move): its epilogue where K1 shares each
    chunk across its row classes (every width at S = 1024), K1's
    whole-chunk form and the in-place fold where K1 takes whole chunks
    (some widths at S = 64)."""
    N = n2 // 2
    n = 300 if S == 1024 else 2000
    gen = torch.Generator(device=dev).manual_seed(n2 * 1000 + S + fb)
    x = torch.randn((n * S + 17, n2), generator=gen, device=dev)
    cr, ci = _correction(N, dev, n2)
    dt = ce._DTYPES[dtype]
    by = dict(ce.chunk_grams_uhat.by_epilogue)
    k1, k9 = ce.chunk_grams_uhat.launches, ce.chunk_embedded.launches
    E, ran = card_kernels(lambda: ce.cov_embedded(
        x, cr, ci, N=N, snapshot_size=S, fb=fb, compute_dtype=dtype))
    assert ce.gram_epilogue(dt) == "embedded"
    assert ce.chunk_grams_uhat.by_epilogue == {
        "gram": by["gram"], "embedded": by["embedded"] + 1}
    assert (ce.chunk_grams_uhat.launches, ce.chunk_embedded.launches) == (
        k1, k9 + 1)
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
    by = dict(ce.chunk_grams_uhat.by_epilogue)
    k1, k9 = ce.chunk_grams_uhat.launches, ce.chunk_embedded.launches
    _, ran = card_kernels(lambda: call.interleaved(x))
    assert ce.chunk_grams_uhat.by_epilogue == {
        "gram": by["gram"], "embedded": by["embedded"] + 1}
    assert (ce.chunk_grams_uhat.launches, ce.chunk_embedded.launches) == (
        k1, k9 + 1)
    assert ran == {"chunk_embedded_kernel": 1}, ran
