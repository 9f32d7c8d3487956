"""The torch port's CUDA kernels against their plain versions, on the card:
the grouped GEMM (forward, dX and tgmm's dW; each in its variants, the
per-variant launch counts showing which kernel ran; the int8 ``gmm_int8``,
``-k int8``) and the three
flash-attention kernels (with the score mods, the band mask and head dims
16 to 128: ``-k flex`` runs those cases alone).

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the kernels have no CPU mode). The file imports torch only, so on a machine
without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import functools

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


# The locked generation path's fp32 shapes on moe-8x40m (block_t, group
# sizes, tail rows): one decode token (2 routed rows, 6 of 8 experts empty,
# a 64-row buffer) and four beams (8 rows over 6 experts) on "f32_decode";
# a 512-token padded prefill (1024 rows in a 1536-row buffer, block_t 64)
# on "f32".
GENERATE_CASES = [
    (8, [0, 8, 0, 0, 0, 8, 0, 0], 48),
    (8, [8, 8, 0, 8, 8, 0, 8, 8], 16),
    (64, [192, 128, 192, 128, 128, 192, 192, 128], 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("block_t,sizes,tail", GENERATE_CASES)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
def test_f32_gmm_generate_shapes_match_plain_and_reject_a_planted_fault(
        cuda, block_t, sizes, tail, K, N):
    x, w, gs = _f32_inputs(sizes, tail, K, N, False)
    got, ref, ran = _run_grouped("forward", x, w, gs, block_t)
    assert ran == {"f32_decode" if block_t == 8 else "f32": 1}
    _assert_matches("forward", got, ref, sizes)
    bad = kernel_check.gmm_skipping_a_tile(x, w, gs, block_t)
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
    # fp32: held to the plain versions evaluated in float64 (kernel_check.reference)
    xo, xlse = kernel_check.reference(tfa.flash_fwd_plain, q, k, v, **kw)
    rdq = kernel_check.reference(tfa.flash_bwd_dq_plain, q, k, v, do, rlse, delta, **kw)
    rdk, rdv = kernel_check.reference(tfa.flash_bwd_dkv_plain, q, k, v, do, rlse, delta, **kw)
    torch.testing.assert_close(lse, xlse, atol=1e-5, rtol=1e-5)
    for name, got, ref in (("o", o, xo), ("dq", dq, rdq), ("dk", dk, rdk),
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
    # head dims 16 and 32 and the band mask are taken now (the mod cases
    # below); D 48 and an unknown mask are not
    q48, k48, v48, _ = _flash_inputs("bfloat16", 1, 4, 4, 128, 48)
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_fwd(q48, k48, v48)
    with pytest.raises(ValueError, match="masks"):
        tfa.flash_fwd(q, k, v, mask_type="diagonal")
    with pytest.raises(ValueError, match="score mod"):
        tfa.flash_fwd(q, k, v, score_mod="alibi", score_arg=0.0)
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
    # at D 16 the wgmma dQ refuses a plan at other tile sizes than its own,
    # and so do the fp32 forward, dQ and dK/dV (64-row tiles) a 32-square
    # one
    q16, k16, v16, do16 = _flash_inputs("bfloat16", 1, 4, 4, 256, 16)
    o16 = torch.empty_like(q16)
    ranges, q_ranges, full = tfa._plan("causal", 0, 0, 256, 32, q.device)
    with pytest.raises(RuntimeError, match="wgmma"):
        tfa._launch("flash_bwd_dq_launch", "wgmma", q16, k16, v16, ranges=ranges, full=full,
                    dout=do16, lse_in=lse, delta=lse, out0=o16, **plan_kw)
    qf, kf, vf, dof = _flash_inputs("float32", 1, 4, 4, 256, 16)
    with pytest.raises(RuntimeError, match="f32"):
        tfa._launch("flash_fwd_launch", "f32", qf, kf, vf, ranges=ranges, full=full,
                    out0=torch.empty_like(qf), lse_out=lse, **plan_kw)
    with pytest.raises(RuntimeError, match="f32"):
        tfa._launch("flash_bwd_dq_launch", "f32", qf, kf, vf, ranges=ranges, full=full,
                    dout=dof, lse_in=lse, delta=lse, out0=torch.empty_like(qf), **plan_kw)
    with pytest.raises(RuntimeError, match="f32"):
        tfa._launch("flash_bwd_dkv_launch", "f32", qf, kf, vf, ranges=q_ranges, full=full,
                    dout=dof, lse_in=lse, delta=lse, out0=torch.empty_like(qf),
                    out1=torch.empty_like(qf), **plan_kw)
    # each library refuses the other's code on a plan at its own tiles: the
    # bf16 one 0 ("f32"), the fp32 one 2 ("wgmma")
    wg_ranges, _, wg_full = tfa._plan("causal", 0, 0, 256, 128, q.device, 128)
    monkeypatch.setitem(tfa._VARIANT_CODES, "wgmma", 0)
    with pytest.raises(RuntimeError, match="wgmma"):
        tfa._launch("flash_fwd_launch", "wgmma", q, k, v, ranges=wg_ranges, full=wg_full,
                    out0=o, lse_out=lse, **plan_kw)
    f32_ranges, _, f32_full = tfa._plan("causal", 0, 0, 256, 64, q.device, 64)
    monkeypatch.setitem(tfa._VARIANT_CODES, "f32", 2)
    with pytest.raises(RuntimeError, match="f32"):
        tfa._launch("flash_fwd_launch", "f32", qf, kf, vf, ranges=f32_ranges, full=f32_full,
                    out0=torch.empty_like(qf), lse_out=lse, **plan_kw)
    # the bf16 SIMT kernels are gone: their old code (3) is refused by all
    # three C entries
    monkeypatch.setitem(tfa._VARIANT_CODES, "simt", 3)
    with pytest.raises(RuntimeError, match="simt"):
        tfa._launch("flash_fwd_launch", "simt", q16, k16, v16, ranges=ranges, full=full,
                    out0=o16, lse_out=lse, **plan_kw)
    with pytest.raises(RuntimeError, match="simt"):
        tfa._launch("flash_bwd_dq_launch", "simt", q16, k16, v16, ranges=ranges, full=full,
                    dout=do16, lse_in=lse, delta=lse, out0=o16, **plan_kw)
    with pytest.raises(RuntimeError, match="simt"):
        tfa._launch("flash_bwd_dkv_launch", "simt", q16, k16, v16, ranges=q_ranges,
                    full=full, dout=do16, lse_in=lse, delta=lse, out0=o16,
                    out1=torch.empty_like(q16), **plan_kw)
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


# (dtype, B, Hq, Hkv, S, D, mask, window, prefix, mod, arg, variant): the score
# mods (alibi over Hq heads, soft_cap at 50 or at 2, where tanh saturates) in
# every variant, the band mask, head dims 16 and 32 (bf16: the wgmma
# kernels on 32- and 64-byte swizzles, every mask) and fp32 (the 3xTF32
# kernels at every head dim, every mask and mod), tails (S 127, 129, 1000),
# GQA 4/2 and 8/2. variant: the forward's and dK/dV's; dQ's is
# flash_variant's (the same).
FLEX_CASES = [
    ("bfloat16", 2, 4, 4, 1024, 64, "causal", 0, 0, "soft_cap", 50.0, "wgmma"),
    ("bfloat16", 2, 4, 4, 1024, 64, "sliding_window", 128, 0, "alibi", 4.0, "wgmma"),
    ("bfloat16", 2, 4, 4, 127, 64, "causal", 0, 0, "soft_cap", 2.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 129, 64, "prefix_lm", 0, 100, "alibi", 4.0, "wgmma"),
    ("bfloat16", 2, 4, 4, 1000, 64, "band", 256, 0, "none", 0.0, "wgmma"),
    ("bfloat16", 2, 4, 4, 1000, 64, "band", 256, 0, "alibi", 4.0, "wgmma"),
    ("bfloat16", 1, 4, 4, 1000, 128, "causal", 0, 0, "soft_cap", 50.0, "wgmma"),
    ("bfloat16", 1, 4, 2, 129, 128, "sliding_window", 100, 0, "alibi", 4.0, "wgmma"),
    ("bfloat16", 2, 6, 6, 512, 16, "sliding_window", 128, 0, "alibi", 6.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 512, 32, "causal", 0, 0, "none", 0.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 127, 32, "band", 40, 0, "soft_cap", 2.0, "wgmma"),
    ("bfloat16", 1, 4, 4, 1000, 16, "prefix_lm", 0, 200, "soft_cap", 50.0, "wgmma"),
    ("bfloat16", 1, 4, 4, 129, 16, "full", 0, 0, "alibi", 4.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 512, 16, "causal", 0, 0, "none", 0.0, "wgmma"),
    ("bfloat16", 1, 4, 4, 127, 16, "causal", 0, 0, "soft_cap", 2.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 1000, 16, "band", 256, 0, "none", 0.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 1000, 32, "sliding_window", 100, 0, "alibi", 4.0, "wgmma"),
    ("bfloat16", 2, 4, 2, 129, 32, "prefix_lm", 0, 100, "soft_cap", 50.0, "wgmma"),
    ("bfloat16", 1, 4, 4, 1000, 32, "full", 0, 0, "alibi", 4.0, "wgmma"),
    ("float32", 1, 4, 2, 200, 16, "sliding_window", 64, 0, "alibi", 4.0, "f32"),
    ("float32", 1, 4, 4, 129, 32, "band", 50, 0, "soft_cap", 2.0, "f32"),
    ("float32", 1, 4, 4, 256, 64, "causal", 0, 0, "soft_cap", 50.0, "f32"),
    ("float32", 2, 8, 2, 1000, 64, "band", 256, 0, "alibi", 8.0, "f32"),
    ("float32", 1, 4, 4, 1000, 128, "prefix_lm", 0, 200, "soft_cap", 50.0, "f32"),
    ("float32", 2, 4, 4, 127, 128, "sliding_window", 100, 0, "none", 0.0, "f32"),
    ("float32", 1, 8, 2, 512, 16, "full", 0, 0, "soft_cap", 2.0, "f32"),
    ("float32", 1, 4, 4, 1000, 32, "causal", 0, 0, "alibi", 4.0, "f32"),
]


def _mod_counts():
    return {n: dict(getattr(tfa, n).launches_by_mod) for n in tfa.FLASH_KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,Hq,Hkv,S,D,mask,window,prefix,mod,arg,variant", FLEX_CASES)
def test_flex_flash_kernels_match_plain(cuda, dtype, B, Hq, Hkv, S, D, mask, window, prefix,
                                        mod, arg, variant):
    q, k, v, do = _flash_inputs(dtype, B, Hq, Hkv, S, D, seed=S + D)
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, scale=D ** -0.5,
              score_mod=mod, score_arg=arg)
    before, before_mod = _flash_counts(), _mod_counts()
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    dq = tfa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    want = {"flash_fwd": variant, "flash_bwd_dkv": variant,
            "flash_bwd_dq": tfa.flash_variant("flash_bwd_dq", getattr(torch, dtype), D)}
    assert want["flash_bwd_dq"] == variant  # dQ at D 16/32 runs wgmma too
    for n in tfa.FLASH_KERNELS:
        assert _flash_counts()[n][want[n]] == before[n][want[n]] + 1, n
        assert _mod_counts()[n][mod] == before_mod[n][mod] + 1, n
    # fp32: held to the plain versions evaluated in float64 (kernel_check.reference)
    xo, xlse = kernel_check.reference(tfa.flash_fwd_plain, q, k, v, **kw)
    rdq = kernel_check.reference(tfa.flash_bwd_dq_plain, q, k, v, do, rlse, delta, **kw)
    rdk, rdv = kernel_check.reference(tfa.flash_bwd_dkv_plain, q, k, v, do, rlse, delta, **kw)
    # lse: fp32 sums in another order; the wgmma kernels' soft_cap takes
    # its tanh from ex2.approx (within ~5e-7 absolute), which moves a score
    # by up to 5e-7 x cap: there 1e-5 + 2^-20 x cap
    atol = 1e-5 + (2.0 ** -20 * arg if mod == "soft_cap" and variant == "wgmma" else 0.0)
    torch.testing.assert_close(lse, xlse, atol=atol, rtol=1e-5)
    for name, got, ref in (("o", o, xo), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        check = kernel_check.compare(got, ref)
        assert check["ok"], (name, check)


@pytest.mark.cuda
@pytest.mark.parametrize("D,mask,window,mod,arg", [
    (64, "causal", 0, "soft_cap", 50.0), (64, "sliding_window", 128, "alibi", 8.0),
    (64, "band", 256, "alibi", 8.0), (16, "sliding_window", 128, "alibi", 8.0),
    (32, "causal", 0, "soft_cap", 50.0)])
def test_flex_planted_fault_is_rejected(cuda, D, mask, window, mod, arg):
    """With a score mod on, each kernel launched with one live tile left out
    of its plan fails the check its faithful launch passes."""
    q, k, v, do = _flash_inputs("bfloat16", 2, 8, 8, 1024, D)
    kw = dict(mask_type=mask, window=window, scale=D ** -0.5, score_mod=mod, score_arg=arg)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    refs = {"o": ro, "dq": tfa.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **kw)}
    refs["dk"], refs["dv"] = tfa.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, **kw)
    good = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
    with kernel_check.planted_fault():
        bad = kernel_check.kernel_outputs(q, k, v, do, rlse, delta, **kw)
    for name, ref in refs.items():
        assert kernel_check.compare(good[name], ref)["ok"], name
        assert not kernel_check.compare(bad[name], ref)["ok"], name


@pytest.mark.cuda
def test_flex_attention_runs_the_kernels_with_the_mod_code(cuda):
    """``flex_attention`` (alibi, sliding window, D 16, bf16) launches the
    wgmma forward, dQ and dK/dV with the alibi code."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flex_attention as tflex
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks as tm

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 512, 6, 16, generator=g).to("cuda", torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    before, before_mod = _flash_counts(), _mod_counts()
    o = tflex.flex_attention(q, k, v, mask_mod=tm.sliding_window(128),
                             score_mod=tflex.alibi_score_fn(6))
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    want = dict.fromkeys(tfa.FLASH_KERNELS, "wgmma")
    for n in tfa.FLASH_KERNELS:
        assert _flash_counts()[n][want[n]] == before[n][want[n]] + 1, n
        assert _mod_counts()[n]["alibi"] == before_mod[n]["alibi"] + 1, n
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# The kernels redesigned last, each against its plain version: the wgmma dQ
# at D 16 and 32 (bf16) and the three 3xTF32 fp32 kernels at every head
# dim. (B, Hq, Hkv, S, mask, window, prefix, mod, arg, layout): tails of one
# row, one 64-row tile, either side of 128, the 1M configs' S 512 and a
# ragged 1000; windows 100 and 300, a prefix of 200 and a band of 256 (not
# multiples of a tile); GQA 4/2 and 8/2; alibi and soft_cap 50; both
# layouts.
REDESIGNED_CASES = [
    (2, 4, 4, 1, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 64, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 127, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 129, "causal", 0, 0, "none", 0.0, "bhsd"),
    (2, 4, 4, 512, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 1000, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 1000, "sliding_window", 100, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 1000, "sliding_window", 300, 0, "none", 0.0, "bhsd"),
    (2, 4, 4, 1000, "prefix_lm", 0, 200, "none", 0.0, "bshd"),
    (2, 4, 4, 1000, "band", 256, 0, "none", 0.0, "bshd"),
    (2, 4, 4, 300, "full", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 2, 512, "causal", 0, 0, "none", 0.0, "bshd"),
    (2, 4, 2, 512, "sliding_window", 128, 0, "alibi", 4.0, "bshd"),
    (2, 4, 4, 1000, "causal", 0, 0, "soft_cap", 50.0, "bshd"),
    (1, 8, 2, 1000, "causal", 0, 0, "none", 0.0, "bshd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype,D", [
    ("flash_bwd_dq", "bfloat16", 16), ("flash_bwd_dq", "bfloat16", 32)]
    + [(kernel, "float32", D) for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
       for D in (16, 32, 64, 128)])
@pytest.mark.parametrize("B,Hq,Hkv,S,mask,window,prefix,mod,arg,layout", REDESIGNED_CASES)
def test_redesigned_flash_kernels_match_plain_repeat_bitwise_and_reject_a_planted_fault(
        cuda, kernel, dtype, D, B, Hq, Hkv, S, mask, window, prefix, mod, arg, layout):
    q, k, v, do = _flash_inputs(dtype, B, Hq, Hkv, S, D, seed=S + D)
    if layout == "bhsd":
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    kw = dict(mask_type=mask, window=window, prefix_len=prefix, scale=D ** -0.5,
              score_mod=mod, score_arg=arg)
    ro, rlse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ro.float()).sum(-1).contiguous()
    ref = functools.partial(kernel_check.reference, **kw)  # fp32: the plain version in float64
    if kernel == "flash_fwd":
        refs = {"o": ref(tfa.flash_fwd_plain, q, k, v)[0]}

        def run():
            o, lse = tfa.flash_fwd(q, k, v, **kw)
            return {"o": o, "lse": lse}
    elif kernel == "flash_bwd_dq":
        refs = {"dq": ref(tfa.flash_bwd_dq_plain, q, k, v, do, rlse, delta)}

        def run():
            return {"dq": tfa.flash_bwd_dq(q, k, v, do, rlse, delta, **kw)}
    else:
        refs = dict(zip(("dk", "dv"), ref(tfa.flash_bwd_dkv_plain, q, k, v, do, rlse, delta)))

        def run():
            return dict(zip(("dk", "dv"), tfa.flash_bwd_dkv(q, k, v, do, rlse, delta, **kw)))
    counts = getattr(tfa, kernel).launches_by_variant
    want = "f32" if dtype == "float32" else "wgmma"
    before = counts[want]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert counts[want] == before + 2
    for name, out in got.items():
        assert torch.equal(out, again[name]), f"{name}: two launches must give the same bits"
    if "lse" in got:
        torch.testing.assert_close(got["lse"], ref(tfa.flash_fwd_plain, q, k, v)[1],
                                   atol=1e-5, rtol=1e-5)
    checked = []
    for name, ref in refs.items():
        assert got[name].shape == ref.shape and got[name].dtype == ref.dtype, name
        if S == 1 and name in ("dq", "dk"):
            # a lone key's softmax has no gradient: both are rounding noise
            assert got[name].abs().max() <= 1e-5 and ref.abs().max() <= 1e-5, name
            continue
        check = kernel_check.compare(got[name], ref)
        assert check["ok"], (name, check)
        checked.append(name)
    if not checked:
        return
    with kernel_check.planted_fault():
        bad = run()
    for name in checked:
        assert not kernel_check.compare(bad[name], refs[name])["ok"], name


# -- the device prefetcher's pinned side-stream copy ---------------------------------
class _SeededLoader:
    """Seeded random batches at 80m-fineweb's shape (B 32, S 2048)."""

    def __init__(self, b=32, s=2048):
        self.b, self.s, self.host = b, s, []

    def generate_batch(self, step):
        rng = np.random.default_rng(step)
        rows = rng.integers(0, 259, (self.b, self.s + 1), dtype=np.int32)
        batch = {"inputs": rows[:, :-1], "targets": rows[:, 1:],
                 "mask": (rows[:, 1:] != 256).astype(np.float32)}
        self.host.append(batch)
        return batch

    def state_dict(self):
        return {"val_ptr": 0}

    def load_state_dict(self, state):
        pass


def _checksums(batch):
    """Position-weighted sums of each tensor, on its device."""
    out = {}
    for k, t in batch.items():
        w = (torch.arange(t.numel(), device=t.device) % 65521 + 1).view(t.shape)
        out[k] = (t.double() * w.double()).sum()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 0])
def test_prefetcher_pinned_side_stream_copy_gives_the_host_batches(cuda, depth):
    from mlx_cuda_distributed_pretraining_tpu_torch.data import DevicePrefetcher

    loader = _SeededLoader()
    pf = DevicePrefetcher(loader, device="cuda", depth=depth, total_steps=12)
    work = torch.randn(4096, 4096, device="cuda")
    seen = []
    try:
        for step in range(12):
            batch, tokens, waits = pf.get()
            assert all(t.is_cuda for t in batch.values())
            before = _checksums(batch)
            for _ in range(8):  # a long step on the compute stream
                work = torch.tanh(work @ work * 1e-3)
            seen.append((before, _checksums(batch), tokens))
            del batch  # freed while the compute stream may still run
    finally:
        pf.stop()
    torch.cuda.synchronize()
    assert all(b.is_pinned() for b in pf._pinned.values())
    assert pf._copy_stream != torch.cuda.current_stream()
    for step, (before, after, tokens) in enumerate(seen):
        host = loader.host[step]
        want = _checksums({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in host.items()})
        for k in want:
            assert before[k].item() == want[k].item() == after[k].item(), (step, k)
        assert tokens == int(host["mask"].sum())


@pytest.mark.cuda
def test_prefetcher_raises_when_pinning_fails(cuda, monkeypatch):
    from mlx_cuda_distributed_pretraining_tpu_torch.data import DevicePrefetcher

    real = torch.empty

    def empty(*args, **kw):
        if kw.get("pin_memory"):
            raise RuntimeError("cannot pin")
        return real(*args, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    pf = DevicePrefetcher(_SeededLoader(b=2, s=16), device="cuda", depth=2, total_steps=3)
    with pytest.raises(RuntimeError, match="cannot pin"):
        pf.get()
    pf.stop()


# gmm_int8 (matmul_precision "int8"): (block_t, group sizes, tail rows) at
# the MoE training tiling (block_t 128), a ragged split with an empty expert
# and a hot one, and the smaller row tiles the kernel takes.
INT8_CASES = [
    (128, [256, 128, 0, 384, 128, 0, 128, 256], 128),
    (128, [0, 0, 1024, 0, 128, 0, 0, 0], 0),
    (64, [64, 0, 192, 64], 64),
    (32, [32, 96, 0, 32], 32),
    (16, [16, 0, 48, 16], 16),
]


def _int8_inputs(dtype, sizes, tail, K, N, seed=11):
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    x[sum(sizes):] = 0.0
    w = (rng.standard_normal((len(sizes), K, N)) * 0.05).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to("cuda", tdt), torch.from_numpy(w).to("cuda", tdt),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("block_t,sizes,tail", INT8_CASES)
# gate/up and down at moe-8x40m's widths; a K no 64-byte slice divides and an
# N no 128-column tile divides
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72)])
def test_gmm_int8_kernel_matches_plain_bitwise(cuda, dtype, block_t, sizes, tail, K, N):
    x, w, gs = _int8_inputs(dtype, sizes, tail, K, N)
    ops = kernel_check.int8_operands(x, w)
    before = tgm.gmm_int8.launches
    out, acc = tgm.gmm_int8_kernel(*ops, gs, block_t, x.dtype, with_products=True)
    torch.cuda.synchronize()
    assert tgm.gmm_int8.launches == before + 1
    ref_acc, ref_out = kernel_check.gmm_int8_plain_outputs(*ops, gs, block_t, x.dtype)
    check = kernel_check.compare_int8(acc, out, ref_acc, ref_out)
    assert check["int32_equal"] and check["ok"], check
    assert torch.equal(out, ref_out)  # the same fp32 epilogue, one rounding
    assert not out[sum(sizes):].any() and not acc[sum(sizes):].any()
    # the wrapper's output is the kernel's
    assert torch.equal(tgm.gmm(x, w, gs, block_t, precision="int8"), out)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
def test_gmm_int8_check_rejects_planted_fault(cuda, K, N):
    block_t, sizes, tail = INT8_CASES[0]
    x, w, gs = _int8_inputs("bfloat16", sizes, tail, K, N)
    ops = kernel_check.int8_operands(x, w)
    ref = kernel_check.gmm_int8_plain_outputs(*ops, gs, block_t, x.dtype)
    acc, out = kernel_check.gmm_int8_skipping_a_tile(*ops, gs, block_t, x.dtype)
    torch.cuda.synchronize()
    check = kernel_check.compare_int8(acc, out, *ref)
    assert not check["ok"] and not check["int32_equal"]


@pytest.mark.cuda
def test_gmm_int8_autograd_runs_the_kernels(cuda):
    # forward on gmm_int8; dX on the bf16 gmm (wgmma at block_t 128); dW on
    # the fp32 tgmm over fp32 copies, held to the plain backward
    block_t, sizes, tail = INT8_CASES[0]
    x, w, gs = _int8_inputs("bfloat16", sizes, tail, 512, 1536)
    g = torch.randn(x.shape[0], 1536, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0)).bfloat16()
    tgm.reset_launches()
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    tgm.gmm(xk, wk, gs, block_t, precision="int8").backward(g)
    torch.cuda.synchronize()
    assert tgm.gmm_int8.launches == 1 and tgm.gmm.launches_by_variant["wgmma"] == 1
    assert tgm.tgmm.launches_by_variant["f32"] == 1
    xp, wp = (t.cpu().requires_grad_() for t in (x, w))
    tgm.gmm(xp, wp, gs.cpu(), block_t, precision="int8").backward(g.cpu())
    assert kernel_check.compare(xk.grad.cpu(), xp.grad)["ok"]
    assert kernel_check.compare_experts(wk.grad.cpu(), wp.grad)["ok"]


@pytest.mark.cuda
def test_gmm_int8_kernel_rejects_bad_input(cuda):
    x, w, gs = _int8_inputs("bfloat16", [16, 16], 0, 64, 32)
    xq, sx, wq, sw = kernel_check.int8_operands(x, w)
    with pytest.raises(ValueError, match="block_t"):
        tgm.gmm_int8_kernel(xq, sx, wq, sw, gs, 8, x.dtype)
    with pytest.raises(TypeError):
        tgm.gmm_int8_kernel(xq.float(), sx, wq, sw, gs, 16, x.dtype)
    with pytest.raises(TypeError):
        tgm.gmm_int8_kernel(xq, sx, wq, sw, gs, 16, torch.float16)


# -- the int8 training path's two kernels at its shapes --------------------------
# moe-8x40m int8 training: B 32 x S 1024 x top-2 = 65,536 selections routed
# over 8 experts, block_t 128, in a 66,560-row buffer (chip_smoke.py's
# routing draw); gate/up K 512, N 1536 and down K 1536, N 512.
PATH_SELECTIONS, PATH_BLOCK_T, PATH_EXPERTS = 65536, 128, 8


def _path_sizes(seed=0):
    g = torch.Generator().manual_seed(seed)
    counts = torch.bincount(torch.randint(0, PATH_EXPERTS, (PATH_SELECTIONS,), generator=g),
                            minlength=PATH_EXPERTS)
    sizes = (counts + PATH_BLOCK_T - 1) // PATH_BLOCK_T * PATH_BLOCK_T
    rows = tgm.round_up(PATH_SELECTIONS + PATH_EXPERTS * (PATH_BLOCK_T - 1), PATH_BLOCK_T)
    return sizes.tolist(), rows - int(sizes.sum())


def _f32_tgmm_inputs(sizes, tail, K, N, bf16_exact, seed=21):
    """x [T, K] and dy [T, N] in fp32 on the card: fp32 copies of bf16
    values (the int8 path's dW operands) or general fp32 values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = sum(sizes) + tail
    x = torch.randn(T, K, device="cuda", generator=g)
    dy = torch.randn(T, N, device="cuda", generator=g)
    x[sum(sizes):] = 0.0
    if bf16_exact:
        x, dy = x.bfloat16().float(), dy.bfloat16().float()
    return x, dy, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _tgmm_float64(x, dy, gs, E, block_t):
    return kernel_check.reference(tgm.tgmm_plain, x, dy, gs, E, block_t)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16_exact", [True, False])
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
def test_f32_tgmm_at_the_int8_path_shapes_against_float64(cuda, K, N, bf16_exact):
    # The 3xTF32 tgmm ("f32") at the int8 path's dW shapes, held to the
    # plain version evaluated in float64 (kernel_check.reference) through
    # the fp32 gate, with the fp32 plain version's own error beside it;
    # two launches give the same bits; the planted fault is rejected.
    sizes, tail = _path_sizes()
    x, dy, gs = _f32_tgmm_inputs(sizes, tail, K, N, bf16_exact)
    E = len(sizes)
    tgm.reset_launches()
    dw = tgm.tgmm(x, dy, gs, E, PATH_BLOCK_T)
    torch.cuda.synchronize()
    assert tgm.tgmm.launches_by_variant["f32"] == 1
    ref = _tgmm_float64(x, dy, gs, E, PATH_BLOCK_T)
    check = kernel_check.compare_experts(dw, ref)
    plain = kernel_check.compare_experts(tgm.tgmm_plain(x, dy, gs, E, PATH_BLOCK_T), ref)
    print(f"f32 tgmm K {K} N {N} bf16-exact {bf16_exact}: normwise {check['norm_err']:.3g} "
          f"limit_ratio {check['limit_ratio']:.3g}; fp32 plain normwise "
          f"{plain['norm_err']:.3g} limit_ratio {plain['limit_ratio']:.3g}")
    assert check["ok"], check
    assert torch.equal(dw, tgm.tgmm(x, dy, gs, E, PATH_BLOCK_T)), "bitwise repeat"
    bad = kernel_check.tgmm_skipping_a_tile(x, dy, gs, E, PATH_BLOCK_T)
    assert not kernel_check.compare_experts(bad, ref)["ok"]


# (block_t, group sizes, tail rows): empty experts and a tail tile; one
# expert holding half the rows; the smoke's block_t 32 case; block_t 8 and
# 24 (a tile that ends inside a 32-row ring stage).
F32_TGMM_EDGES = [
    (128, [1024, 0, 256, 0, 0, 384, 128, 0], 256),
    (128, [4096, 640, 512, 640, 512, 640, 512, 640], 128),
    (32, [96, 160, 0, 32, 224, 64, 0, 128], 64),
    (8, [8, 0, 40, 8, 0, 16], 24),
    (24, [48, 0, 72, 24], 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("block_t,sizes,tail", F32_TGMM_EDGES)
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72), (100, 36)])
def test_f32_tgmm_edges_against_float64(cuda, block_t, sizes, tail, K, N):
    x, dy, gs = _f32_tgmm_inputs(sizes, tail, K, N, bf16_exact=False, seed=block_t)
    E = len(sizes)
    if K == 100:  # x 4 bytes past a 16-byte boundary: the kernel's 4-byte copies
        x = torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    dw = tgm.tgmm(x, dy, gs, E, block_t)
    ref = _tgmm_float64(x, dy, gs, E, block_t)
    check = kernel_check.compare_experts(dw, ref)
    assert check["ok"], check
    for e, n in enumerate(sizes):
        if n == 0:
            assert not dw[e].any(), f"empty expert {e} must be exact zeros"
    assert torch.equal(dw, tgm.tgmm(x, dy, gs, E, block_t))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512)])
def test_gmm_int8_wgmma_at_the_path_shapes_matches_plain_bitwise(cuda, K, N):
    # gmm_int8 at the int8 path's shapes runs the s8 wgmma kernel; its int32
    # sums equal the plain version's bit for bit and its bf16 output the
    # plain epilogue's; the planted fault is rejected.
    sizes, tail = _path_sizes()
    x, w, gs = _int8_inputs("bfloat16", sizes, tail, K, N)
    ops = kernel_check.int8_operands(x, w)
    tgm.reset_launches()
    out, acc = tgm.gmm_int8_kernel(*ops, gs, PATH_BLOCK_T, x.dtype, with_products=True)
    torch.cuda.synchronize()
    assert tgm.gmm_int8.launches_by_variant == {"wgmma": 1, "mma_sync": 0}
    ref_acc, ref_out = kernel_check.gmm_int8_plain_outputs(*ops, gs, PATH_BLOCK_T, x.dtype)
    check = kernel_check.compare_int8(acc, out, ref_acc, ref_out)
    assert check["int32_equal"] and check["ok"], check
    assert torch.equal(out, ref_out)
    bad = kernel_check.compare_int8(*kernel_check.gmm_int8_skipping_a_tile(
        *ops, gs, PATH_BLOCK_T, x.dtype), ref_acc, ref_out)
    assert not bad["ok"] and not bad["int32_equal"]


@pytest.mark.cuda
@pytest.mark.parametrize("block_t,sizes,tail", INT8_CASES)
def test_gmm_int8_variant_follows_the_shapes(cuda, block_t, sizes, tail):
    # wgmma at block_t 64 and 128, mma.sync at 16 and 32 (no wgmma row tile
    # below 64), and mma.sync where N is not a multiple of 8; each launch
    # counted under its variant, every one bitwise the plain version's.
    for K, N in ((512, 1536), (96, 36)):
        x, w, gs = _int8_inputs("bfloat16", sizes, tail, K, N)
        ops = kernel_check.int8_operands(x, w)
        want = tgm.gmm_int8_variant(block_t, N)
        assert want == ("wgmma" if block_t % 64 == 0 and N % 8 == 0 else "mma_sync")
        tgm.reset_launches()
        out, acc = tgm.gmm_int8_kernel(*ops, gs, block_t, x.dtype, with_products=True)
        torch.cuda.synchronize()
        assert tgm.gmm_int8.launches_by_variant == {**dict.fromkeys(
            tgm.GMM_INT8_VARIANTS, 0), want: 1}
        ref_acc, ref_out = kernel_check.gmm_int8_plain_outputs(*ops, gs, block_t, x.dtype)
        assert torch.equal(acc, ref_acc) and torch.equal(out, ref_out)
