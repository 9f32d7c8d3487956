"""The torch port's CUDA kernels against their plain versions, on the card:
the grouped GEMM (forward, dX and tgmm's dW; each in its variants, the
per-variant launch counts showing which kernel ran) and the three
flash-attention kernels.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the kernels have no CPU mode). The file imports torch only, so on a machine
without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as tfa
from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check
from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as tgm

# (block_t, group sizes, tail rows): the serving path's decode and prefill
# tilings, empty groups and tail tiles.
CASES = [
    (8, [8, 0, 16, 8], 16),
    (8, [8, 8, 0, 0, 16, 8, 8, 8], 16),
    (32, [32, 64, 0, 32], 32),
    (16, [0, 48, 16, 0], 16),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_t,sizes,tail", CASES)
# gate/up and down at moe-8x40m's widths, and widths no tile divides
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72)])
def test_gmm_kernel_matches_plain(cuda, dtype, block_t, sizes, tail, K, N):
    rng = np.random.default_rng(0)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[sum(sizes):] = 0.0
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to("cuda", tdt),
            torch.from_numpy(w).to("cuda", tdt),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"), block_t)
    before = tgm.gmm.launches
    out = tgm.gmm(*args)
    torch.cuda.synchronize()
    assert tgm.gmm.launches == before + 1
    ref = tgm.gmm_plain(*args)
    # fp32: summation order only; bf16: one rounding of the fp32 sum.
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert not out[sum(sizes):].any()


# The fp32 kernels ("f32_decode" at block_t 8, "f32" at 16 and 32): (block_t,
# group sizes, tail rows) at the serving path's tilings; one expert holding
# every selection (decode: 16 selections; prefill: 512); empty groups and tail
# tiles.
F32_CASES = [
    (8, [8, 0, 8, 8, 0, 8, 0, 8], 32),
    (8, [0, 0, 0, 16, 0, 0, 0, 0], 56),
    (8, [0, 8, 0, 0, 0, 0, 16, 0], 48),
    (16, [0, 48, 16, 0, 32, 0, 0, 16], 128),
    (32, [64, 96, 32, 0, 64, 96, 64, 96], 256),
    (32, [0, 0, 512, 0, 0, 0, 0, 0], 256),
    (32, [32, 0, 0, 64, 0, 0, 0, 0], 96),
]


def _f32_inputs(sizes, tail, K, N, w_trans, seed=6):
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[sum(sizes):] = 0.0
    w = (rng.standard_normal((len(sizes), N, K) if w_trans else (len(sizes), K, N))
         / K ** 0.5).astype(np.float32)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda(),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("w_trans", [False, True])
@pytest.mark.parametrize("block_t,sizes,tail", F32_CASES)
# moe-8x40m's gate/up and down widths, and widths no tile divides (K 200:
# a partial last stage and K chunk; N 72: a partial column strip)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72)])
def test_f32_gmm_kernels_match_plain_and_repeat_bitwise(cuda, block_t, sizes, tail, K, N,
                                                       w_trans):
    x, w, gs = _f32_inputs(sizes, tail, K, N, w_trans)
    got, ref, ran = _run_grouped("dx" if w_trans else "forward", x, w, gs, block_t)
    assert ran == {"f32_decode" if block_t == 8 else "f32": 1}
    _assert_matches("forward", got, ref, sizes)  # kernel_check's fp32 limits
    again = tgm._gmm_forward(x, w, gs, block_t, w_trans)
    assert torch.equal(got, again), "two launches must give the same bits"


@pytest.mark.cuda
@pytest.mark.parametrize("block_t", [8, 16, 32])
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
def test_f32_gmm_error_against_float64(cuda, block_t, K, N):
    # The kernels against the float64 product, beside the plain version (fp32
    # cuBLAS, TF32 off): 3xTF32 (f32) and the FMA stream (f32_decode) must
    # stay within 4x the plain version's normwise error (3xTF32 drops the
    # lo.lo term, ~2^-22 of each product, far below fp32 summation noise).
    rng = np.random.default_rng(7)
    sizes = (rng.multinomial(16 if block_t == 8 else 512, [1 / 8] * 8)
             + block_t - 1) // block_t * block_t
    x, w, gs = _f32_inputs(sizes.tolist(), block_t * 4, K, N, False, seed=7)
    n_live = int(sizes.sum()) // block_t
    te = tgm.tile_experts(gs, n_live, block_t)
    live = torch.bmm(x[:n_live * block_t].double().reshape(n_live, block_t, K),
                     w.double()[te]).reshape(-1, N)

    def err(out):
        return ((out[:live.shape[0]].double() - live).norm() / live.norm()).item()

    kernel, plain = err(tgm.gmm(x, w, gs, block_t)), err(tgm.gmm_plain(x, w, gs, block_t))
    print(f"normwise error vs float64, block_t {block_t}, K {K}, N {N}: "
          f"kernel {kernel:.3g}, plain {plain:.3g}")
    assert kernel <= 4 * plain, (kernel, plain)


@pytest.mark.cuda
def test_f32_gmm_check_rejects_planted_fault(cuda):
    # The serving path's prefill tiling (block_t 32, 8 experts): the last
    # live row tile left out must fail the check that the kernel passes.
    rng = np.random.default_rng(8)
    sizes = ((rng.multinomial(512, [1 / 8] * 8) + 31) // 32 * 32).tolist()
    x, w, gs = _f32_inputs(sizes, 768 - sum(sizes), 1536, 512, False)
    got, ref, ran = _run_grouped("forward", x, w, gs, 32)
    assert ran == {"f32": 1} and kernel_check.compare(got, ref)["ok"]
    bad = kernel_check.gmm_skipping_a_tile(x, w, gs, 32)
    assert not kernel_check.compare(bad, ref)["ok"]


# (block_t, group sizes, tail rows) for tgmm: the training path's tile, the
# decode and prefill tiles, empty groups, tail tiles and an empty last expert.
TGMM_CASES = [
    (128, [256, 128, 0, 384], 128),
    (8, [8, 0, 16, 8], 16),
    (32, [32, 64, 0, 32, 0], 32),
    (16, [0, 48, 16, 0], 16),
]


def _tgmm_inputs(dtype, sizes, tail, K, N, seed=0):
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    x[sum(sizes):] = 0.0
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to("cuda", tdt), torch.from_numpy(dy).to("cuda", tdt),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_t,sizes,tail", TGMM_CASES)
# gate/up and down at moe-8x40m's widths, and widths no tile divides (bf16
# with K, N not multiples of 8 takes the kernel's scalar loads)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72), (100, 36)])
def test_tgmm_kernel_matches_plain(cuda, dtype, block_t, sizes, tail, K, N):
    x, dy, gs = _tgmm_inputs(dtype, sizes, tail, K, N)
    before = tgm.tgmm.launches
    dw = tgm.tgmm(x, dy, gs, len(sizes), block_t)
    torch.cuda.synchronize()
    assert tgm.tgmm.launches == before + 1
    ref = tgm.tgmm_plain(x, dy, gs, len(sizes), block_t)
    assert dw.shape == ref.shape and dw.dtype == ref.dtype
    check = kernel_check.compare_experts(dw, ref)
    assert check["ok"], check
    for e, n in enumerate(sizes):
        if n == 0:
            assert not dw[e].any(), f"empty expert {e} must be exact zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_t,sizes,tail", CASES)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72)])
def test_gmm_dx_kernel_matches_plain(cuda, dtype, block_t, sizes, tail, K, N):
    # The backward's dX: dy [T, N] against w [E, K, N] read transposed in place.
    rng = np.random.default_rng(1)
    T = sum(sizes) + tail
    dy = rng.standard_normal((T, N)).astype(np.float32)
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    tdt = getattr(torch, dtype)
    dy, w = (torch.from_numpy(a).to("cuda", tdt) for a in (dy, w))
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    before = tgm.gmm.launches
    dx = tgm._gmm_forward(dy, w, gs, block_t, w_trans=True)
    torch.cuda.synchronize()
    assert tgm.gmm.launches == before + 1
    ref = tgm.gmm_plain(dy, w.transpose(1, 2), gs, block_t)
    assert kernel_check.compare(dx, ref)["ok"]
    assert not dx[sum(sizes):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_autograd_runs_the_kernels(cuda, dtype):
    # One forward and backward through gmm: 2 gmm launches (forward, dX) and
    # 1 tgmm launch, with the gradients of the plain versions on the CPU.
    rng = np.random.default_rng(2)
    sizes, K, N = [32, 0, 64, 32], 64, 96
    x = rng.standard_normal((sum(sizes) + 32, K)).astype(np.float32)
    x[sum(sizes):] = 0.0
    w = rng.standard_normal((4, K, N)).astype(np.float32)
    g = rng.standard_normal((x.shape[0], N)).astype(np.float32)
    tdt = getattr(torch, dtype)
    grads = {}
    for dev in ("cuda", "cpu"):
        xt, wt = (torch.from_numpy(a).to(dev, tdt).requires_grad_() for a in (x, w))
        before = (tgm.gmm.launches, tgm.tgmm.launches)
        out = tgm.gmm(xt, wt, torch.tensor(sizes, dtype=torch.int32, device=dev), 32)
        out.backward(torch.from_numpy(g).to(dev, tdt))
        launched = (tgm.gmm.launches - before[0], tgm.tgmm.launches - before[1])
        assert launched == ((2, 1) if dev == "cuda" else (0, 0))
        grads[dev] = (out.detach(), xt.grad, wt.grad)
    out, dx, dw = (t.cpu() for t in grads["cuda"])
    assert kernel_check.compare(out, grads["cpu"][0])["ok"]
    assert kernel_check.compare(dx, grads["cpu"][1])["ok"]
    assert kernel_check.compare_experts(dw, grads["cpu"][2])["ok"]


@pytest.mark.cuda
def test_tgmm_check_rejects_planted_fault(cuda):
    # The training path's tiling (block_t 128, 8 experts) on fewer rows: the
    # last expert's last row tile left out of the kernel's walk must fail
    # the same check that the correct kernel passes.
    rng = np.random.default_rng(3)
    sizes = (rng.multinomial(8192, [1 / 8] * 8) + 127) // 128 * 128
    x, dy, gs = _tgmm_inputs("bfloat16", sizes.tolist(), 128, 512, 1536)
    ref = tgm.tgmm_plain(x, dy, gs, 8, 128)
    assert kernel_check.compare_experts(tgm.tgmm(x, dy, gs, 8, 128), ref)["ok"]
    bad = kernel_check.tgmm_skipping_a_tile(x, dy, gs, 8, 128)
    assert not kernel_check.compare_experts(bad, ref)["ok"]


@pytest.mark.cuda
def test_tgmm_kernel_rejects_bad_input(cuda):
    x = torch.zeros((24, 64), device="cuda")
    dy = torch.zeros((24, 32), device="cuda")
    gs = torch.tensor([8, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block_t"):
        tgm.tgmm(x, dy, gs, 2, 12)
    with pytest.raises(TypeError, match="int32"):
        tgm.tgmm(x, dy, gs.long(), 2, 8)
    with pytest.raises(TypeError, match="one type"):
        tgm.tgmm(x, dy.bfloat16(), gs, 2, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.tgmm(x.t().contiguous().t(), dy, gs, 2, 8)
    with pytest.raises(ValueError, match="shapes"):
        tgm.tgmm(x, dy[:16], gs, 2, 8)
    with pytest.raises(ValueError, match="different devices"):
        tgm.tgmm(x, dy, gs.cpu(), 2, 8)
    with pytest.raises(ValueError, match="2 group sizes for 3 experts"):
        tgm.tgmm(x, dy, gs, 3, 8)


@pytest.mark.cuda
def test_gmm_kernel_rejects_bad_input(cuda):
    x = torch.zeros((24, 64), device="cuda")
    w = torch.zeros((2, 64, 64), device="cuda")
    gs = torch.tensor([8, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="block_t"):
        tgm.gmm(x, w, gs, 12)
    with pytest.raises(TypeError, match="int32"):
        tgm.gmm(x, w, gs.long(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.gmm(x.t().contiguous().t(), w, gs, 8)


# bf16 at block_t 64 and 128 takes the TMA/wgmma kernels. (block_t, group
# sizes, tail rows): 64-row CTA tiles with an empty group and tail tiles; an
# empty last expert and tail tiles; one hot expert.
WGMMA_CASES = [
    (64, [64, 0, 128, 64], 64),
    (128, [256, 128, 0, 384, 0], 128),
    (128, [1024, 128, 0, 128], 0),
]


def _grouped_inputs(op, sizes, tail, K, N, seed=4):
    """bf16 operands of one grouped product: x [T, K] (tail rows zero) and,
    for "forward", w [E, K, N]; for "dx", w [E, N, K] (read transposed);
    for "tgmm", dy [T, N]."""
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[sum(sizes):] = 0.0
    shape = {"forward": (len(sizes), K, N), "dx": (len(sizes), N, K), "tgmm": (T, N)}[op]
    other = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to("cuda", torch.bfloat16),
            torch.from_numpy(other).to("cuda", torch.bfloat16),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"))


def _run_grouped(op, x, other, gs, block_t):
    """(kernel output, plain output, launches by variant of that call)."""
    counter = (tgm.tgmm if op == "tgmm" else tgm.gmm).launches_by_variant
    before = dict(counter)
    if op == "tgmm":
        got = tgm.tgmm(x, other, gs, len(gs), block_t)
        ref = tgm.tgmm_plain(x, other, gs, len(gs), block_t)
    else:
        wt = op == "dx"
        got = tgm._gmm_forward(x, other, gs, block_t, wt)
        ref = tgm.gmm_plain(x, other.transpose(1, 2) if wt else other, gs, block_t)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in counter.items() if n != before[k]}
    return got, ref, ran


def _assert_matches(op, got, ref, sizes):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    check = (kernel_check.compare_experts if op == "tgmm" else kernel_check.compare)(got, ref)
    assert check["ok"], check
    if op == "tgmm":
        for e, n in enumerate(sizes):
            if n == 0:
                assert not got[e].any(), f"empty expert {e} must be exact zeros"
    else:
        assert not got[sum(sizes):].any(), "tail rows must come out zero"


def _wmma_tgmm(x, dy, gs, block_t):
    """bf16 tgmm on the WMMA kernel (``tgmm_backward``'s kernel code 1),
    through the library's C entry: what the wgmma kernel must equal element
    by element (the same rounding points, the same fp32 products)."""
    E, (T, K), N = len(gs), x.shape, dy.shape[1]
    dw = torch.empty((E, K, N), dtype=x.dtype, device=x.device)
    err = tgm._library().tgmm_backward(
        x.data_ptr(), dy.data_ptr(), gs.data_ptr(), dw.data_ptr(), T, K, N, E,
        block_t, 1, tgm._stream(x))
    assert err == 0, f"WMMA tgmm launch failed with CUDA error {err}"
    torch.cuda.synchronize()
    return dw


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["forward", "dx", "tgmm"])
@pytest.mark.parametrize("block_t,sizes,tail", WGMMA_CASES)
# moe-8x40m's gate/up and down widths, and widths no tile divides that meet
# TMA's rules (K 200: not a multiple of 64)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72)])
def test_wgmma_kernels_match_plain(cuda, op, block_t, sizes, tail, K, N):
    x, other, gs = _grouped_inputs(op, sizes, tail, K, N)
    got, ref, ran = _run_grouped(op, x, other, gs, block_t)
    assert ran == {"wgmma": 1}
    _assert_matches(op, got, ref, sizes)
    if op == "tgmm":
        assert torch.equal(got, _wmma_tgmm(x, other, gs, block_t))


@pytest.mark.cuda
# tgmm's 128 x 128 dW blocks at ragged edges: an odd number of K blocks
# (K 384), of N blocks (N 640) or both; a block holding one live box of K
# and of N (K 320, N 200); block_t 128 (two stages a tile, the path's) and
# 64 (one)
@pytest.mark.parametrize("block_t", [128, 64])
@pytest.mark.parametrize("K,N", [(384, 512), (512, 640), (384, 640), (320, 200)])
def test_wgmma_tgmm_ragged_edges_equal_wmma(cuda, K, N, block_t):
    sizes, tail = [256, 0, 128, 384], 128
    x, dy, gs = _grouped_inputs("tgmm", sizes, tail, K, N)
    got, ref, ran = _run_grouped("tgmm", x, dy, gs, block_t)
    assert ran == {"wgmma": 1}
    _assert_matches("tgmm", got, ref, sizes)
    assert torch.equal(got, _wmma_tgmm(x, dy, gs, block_t))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["forward", "dx", "tgmm"])
@pytest.mark.parametrize("why", ["K not a multiple of 8", "unaligned view"])
def test_wgmma_preconditions_fall_to_wmma(cuda, op, why):
    # A call outside TMA's rules takes the WMMA kernel, chosen before launch.
    sizes, tail, block_t = [128, 0, 256], 128, 128
    K = 100 if why == "K not a multiple of 8" else 64
    x, other, gs = _grouped_inputs(op, sizes, tail, K, 48)
    if why == "unaligned view":  # contiguous, 2 bytes past a 16-byte boundary
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
        x = buf[1:1 + x.numel()].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    got, ref, ran = _run_grouped(op, x, other, gs, block_t)
    assert ran == {"wmma": 1}
    _assert_matches(op, got, ref, sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("w_trans", [False, True])
def test_gmm_check_rejects_planted_fault(cuda, w_trans):
    # The training path's tiling (block_t 128, 8 experts) on fewer rows: the
    # last live row tile left out of the wgmma kernel's grid must fail the
    # same check that the correct kernel passes.
    rng = np.random.default_rng(5)
    sizes = ((rng.multinomial(8192, [1 / 8] * 8) + 127) // 128 * 128).tolist()
    x, w, gs = _grouped_inputs("dx" if w_trans else "forward", sizes, 128, 512, 1536)
    got, ref, ran = _run_grouped("dx" if w_trans else "forward", x, w, gs, 128)
    assert ran == {"wgmma": 1} and kernel_check.compare(got, ref)["ok"]
    bad = kernel_check.gmm_skipping_a_tile(x, w, gs, 128, w_trans)
    assert not kernel_check.compare(bad, ref)["ok"]


# (dtype, B, Hq, Hkv, S, D, mask): the training path's shape at a smaller
# batch, fp32, GQA, tail tiles, the other masks and D 128.
FLASH_CASES = [
    ("bfloat16", 4, 8, 8, 1024, 64, "causal"),
    ("float32", 2, 8, 8, 256, 64, "causal"),
    ("bfloat16", 2, 8, 2, 256, 64, "causal"),
    ("bfloat16", 2, 4, 4, 1000, 64, "causal"),
    ("float32", 1, 4, 2, 200, 64, "causal"),
    ("bfloat16", 2, 4, 4, 512, 64, "sliding_window"),
    ("bfloat16", 2, 4, 4, 512, 64, "prefix_lm"),
    ("bfloat16", 2, 4, 4, 300, 64, "full"),
    ("bfloat16", 2, 4, 4, 512, 128, "causal"),
    ("float32", 1, 4, 4, 256, 128, "causal"),
]


def _flash_inputs(dtype, B, Hq, Hkv, S, D, seed=0):
    """q, k, v, dO as [B, H, S, D] views of [B, S, H, D] tensors (the
    layout the model hands the kernels)."""
    g = torch.Generator().manual_seed(seed)
    tdt = getattr(torch, dtype)
    return [torch.randn(B, S, h, D, generator=g).to("cuda", tdt).transpose(1, 2)
            for h in (Hq, Hkv, Hkv, Hq)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,Hq,Hkv,S,D,mask", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, B, Hq, Hkv, S, D, mask):
    q, k, v, do = _flash_inputs(dtype, B, Hq, Hkv, S, D)
    kw = dict(mask_type=mask, window=96, prefix_len=80, scale=D ** -0.5)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    rdq = tfa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = tfa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)
    for name, got, ref in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        check = kernel_check.compare(got, ref)
        assert check["ok"], (name, check)


@pytest.mark.cuda
def test_kernel_check_rejects_planted_fault(cuda):
    # The training path's shape at a smaller batch; each kernel launched
    # with one live tile left out of its plan must fail the same check.
    q, k, v, do = _flash_inputs("bfloat16", 4, 8, 8, 1024, 64)
    kw = dict(mask_type="causal", scale=64 ** -0.5)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    refs = {"o": ro,
            "dq": tfa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)}
    refs["dk"], refs["dv"] = tfa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    good = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
    with kernel_check.planted_fault():
        bad = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
    for name, ref in refs.items():
        assert kernel_check.compare(good[name], ref)["ok"], name
        assert not kernel_check.compare(bad[name], ref)["ok"], name


@pytest.mark.cuda
def test_flash_kernels_reject_bad_input(cuda):
    q, k, v, do = _flash_inputs("bfloat16", 1, 4, 4, 128, 64)
    lse = torch.zeros((1, 4, 128), device="cuda")
    with pytest.raises(TypeError, match="want"):  # a CPU tensor among CUDA ones
        tfa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tfa.flash_fwd(q.half(), k.half(), v.half())
    q32, k32, v32, _ = _flash_inputs("bfloat16", 1, 4, 4, 128, 32)
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_fwd(q32, k32, v32)
    with pytest.raises(ValueError, match="masks"):
        tfa.flash_fwd(q, k, v, mask_type="band")
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_bwd_dq(q, k, v, do, lse.transpose(1, 2).contiguous()
                         .transpose(1, 2), lse)
    with pytest.raises(TypeError, match="fp32 or bf16"):  # no quiet fallback
        tfa.flash_attention(*(t.transpose(1, 2).half() for t in (q, k, v)))


# (B, Hq, Hkv, S, D, mask, window, prefix, layout): the wgmma forward's 128-row
# Q and KV tiles, dQ's 128-row Q / 128-row (D 64) or 64-row (D 128) KV tiles
# and dK/dV's 128-row KV / 128-row (D 64) or 64-row (D 128) Q tiles at their edges
# (S of one row, one 64-row tile, either side of 128, ragged 1000, 16 KV
# tiles), windows and a prefix that are not multiples of 128, GQA and D
# 128; "bshd": [B, H, S, D] views of [B, S, H, D] tensors (the model's),
# "bhsd": contiguous [B, H, S, D].
WGMMA_FLASH_CASES = [
    (2, 4, 4, 1, 64, "causal", 0, 0, "bshd"),
    (2, 4, 4, 64, 64, "causal", 0, 0, "bshd"),
    (2, 4, 4, 127, 64, "causal", 0, 0, "bshd"),
    (2, 4, 4, 129, 64, "causal", 0, 0, "bhsd"),
    (2, 4, 4, 1000, 64, "causal", 0, 0, "bshd"),
    (1, 4, 4, 2048, 64, "causal", 0, 0, "bshd"),
    (2, 4, 4, 1000, 64, "sliding_window", 100, 0, "bshd"),
    (2, 4, 4, 1000, 64, "sliding_window", 300, 0, "bhsd"),
    (2, 4, 4, 1000, 64, "prefix_lm", 0, 200, "bshd"),
    (2, 4, 4, 300, 64, "full", 0, 0, "bshd"),
    (2, 8, 1, 1000, 64, "causal", 0, 0, "bshd"),
    (2, 8, 2, 512, 64, "causal", 0, 0, "bshd"),
    (2, 4, 4, 1000, 128, "causal", 0, 0, "bshd"),
    (2, 4, 4, 129, 128, "sliding_window", 100, 0, "bshd"),
    (2, 4, 2, 1000, 128, "prefix_lm", 0, 200, "bhsd"),
]


def _flash_counts():
    return {n: dict(getattr(tfa, n).launches_by_variant) for n in tfa.FLASH_KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,mask,window,prefix,layout", WGMMA_FLASH_CASES)
def test_wgmma_flash_kernels_match_plain(cuda, B, Hq, Hkv, S, D, mask, window, prefix,
                                         layout):
    q, k, v, do = _flash_inputs("bfloat16", B, Hq, Hkv, S, D, seed=S)
    if layout == "bhsd":
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, scale=D ** -0.5)
    before = _flash_counts()
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    after = _flash_counts()
    ran = {n: {v_: c - before[n][v_] for v_, c in after[n].items() if c != before[n][v_]}
           for n in tfa.FLASH_KERNELS}
    assert ran == {"flash_fwd": {"wgmma": 1}, "flash_bwd_dq": {"wgmma": 1},
                   "flash_bwd_dkv": {"wgmma": 1}}
    rdq = tfa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = tfa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=1e-5)
    outs = [("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)]
    if S == 1:
        # A lone key's softmax has no gradient: dS = p (dP - delta) is the
        # fp32 rounding of dO.v - dO.o with o = v, in both versions alike,
        # so dQ and dK are rounding noise; hold both to zero instead of each
        # other.
        for got, ref in ((dq, rdq), (dk, rdk)):
            assert got.abs().max() <= 1e-5 and ref.abs().max() <= 1e-5
        outs = [outs[0], outs[3]]
    for name, got, ref in outs:
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        check = kernel_check.compare(got, ref)
        assert check["ok"], (name, check)


@pytest.mark.cuda
def test_wgmma_flash_planted_fault_is_rejected(cuda):
    # One live tile left out of each wgmma plan (the forward's and dQ's
    # 128 x 128, dK/dV's 128 x 128) at the training path's shape on fewer
    # heads: the same check that passes the kernels must fail them.
    q, k, v, do = _flash_inputs("bfloat16", 2, 8, 8, 1024, 64)
    kw = dict(mask_type="causal", scale=64 ** -0.5)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    refs = {"o": ro, "dq": tfa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)}
    refs["dk"], refs["dv"] = tfa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    before = _flash_counts()
    with kernel_check.planted_fault():
        bad = {"o": tfa.flash_fwd(q, k, v, **kw)[0],
               "dq": tfa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)}
        bad["dk"], bad["dv"] = tfa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    after = _flash_counts()
    for n in tfa.FLASH_KERNELS:
        assert after[n]["wgmma"] == before[n]["wgmma"] + 1, n
    for name, ref in refs.items():
        assert not kernel_check.compare(bad[name], ref)["ok"], name


@pytest.mark.cuda
def test_wgmma_flash_bad_input_raises_without_a_launch(cuda, monkeypatch):
    q, k, v, do = _flash_inputs("bfloat16", 1, 4, 4, 256, 64)
    o = torch.empty_like(q)
    lse = torch.empty((1, 4, 256), device="cuda")
    before = _flash_counts()
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    shifted = buf[1:1 + q.numel()].view(q.shape)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(shifted, k, v)
    # the library refuses a plan at other tile sizes than the wgmma kernel's
    ranges, q_ranges, full = tfa._plan("causal", 0, 0, 256, 64, q.device)
    plan_kw = dict(mask_type="causal", window=0, prefix_len=0, scale=0.125)
    with pytest.raises(RuntimeError, match="wgmma"):
        tfa._launch("flash_fwd_launch", "wgmma", q, k, v, ranges=ranges, full=full,
                    out0=o, lse_out=lse, **plan_kw)
    with pytest.raises(RuntimeError, match="wgmma"):
        tfa._launch("flash_bwd_dkv_launch", "wgmma", q, k, v, ranges=q_ranges, full=full,
                    dout=do, lse_in=lse, delta=lse, out0=o, out1=torch.empty_like(q),
                    **plan_kw)
    # dQ's wgmma kernel too (it plans at 128 x 128 at D 64)
    with pytest.raises(RuntimeError, match="wgmma"):
        tfa._launch("flash_bwd_dq_launch", "wgmma", q, k, v, ranges=ranges, full=full,
                    dout=do, lse_in=lse, delta=lse, out0=o, **plan_kw)
    # the library no longer builds any bf16 WMMA kernel: its old code (1) is
    # refused by all three C entries
    monkeypatch.setitem(tfa._VARIANT_CODES, "wmma", 1)
    ranges, q_ranges, full = tfa._plan("causal", 0, 0, 256, 64, q.device)
    with pytest.raises(RuntimeError, match="wmma"):
        tfa._launch("flash_fwd_launch", "wmma", q, k, v, ranges=ranges, full=full,
                    out0=o, lse_out=lse, **plan_kw)
    with pytest.raises(RuntimeError, match="wmma"):
        tfa._launch("flash_bwd_dq_launch", "wmma", q, k, v, ranges=ranges, full=full,
                    dout=do, lse_in=lse, delta=lse, out0=o, **plan_kw)
    with pytest.raises(RuntimeError, match="wmma"):
        tfa._launch("flash_bwd_dkv_launch", "wmma", q, k, v, ranges=q_ranges, full=full,
                    dout=do, lse_in=lse, delta=lse, out0=o, out1=torch.empty_like(q),
                    **plan_kw)
    torch.cuda.synchronize()
    assert _flash_counts() == before
