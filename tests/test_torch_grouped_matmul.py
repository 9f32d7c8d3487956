"""The torch port's grouped expert GEMM against the JAX package's.

On the CPU the port's ``gmm`` runs its plain version (the blocked
formulation) and its backward's ``tgmm_plain``; they are held against the
JAX Pallas kernels run in interpret mode (``backend="pallas"``,
``_tgmm_pallas``), as tests/test_moe.py runs them. The CUDA kernels
themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.ops import grouped_matmul as jgm
from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as tgm
from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

# (block_t, group sizes, tail rows past the last group): an empty group and
# tail tiles in every case.
CASES = [
    (8, [8, 0, 16, 8], 16),
    (32, [32, 64, 0, 32], 32),
    (8, [0, 24, 8, 0], 8),
]


def _inputs(sizes, tail, seed=0, K=48, N=40):
    """x rows inside each group are data except the last row of every
    group (zero padding, as the dispatcher leaves it); tail rows are zero."""
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = rng.standard_normal((T, K)).astype(np.float32)
    ends = np.cumsum(sizes)
    for e, n in zip(ends, sizes):
        if n:
            x[e - 1] = 0.0
    x[sum(sizes):] = 0.0
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("block_t,sizes,tail", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_pallas_interpret(block_t, sizes, tail, dtype):
    x, w, gs = _inputs(sizes, tail)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = jgm.gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(gs),
                  block_t=block_t, backend="pallas")
    out = tgm.gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                  torch.from_numpy(gs), block_t)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    if dtype == "float32":
        # fp32 products summed in another order: a few ulps of |x||w|.
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        # Both accumulate exact bf16 products in fp32 and round once to
        # bf16; a different summation order can move that rounding by one
        # bf16 ulp (2**-8 relative).
        np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2 ** -7)
    assert not got[sum(sizes):].any(), "tail rows must come out zero"


def test_pick_block_t_matches_jax():
    for rows in list(range(1, 300, 7)) + [512, 1024, 4096, 16384]:
        for experts in (0, 1, 4, 8, 64):
            assert tgm.pick_block_t(rows, experts) == \
                jgm.pick_block_t(rows, experts), (rows, experts)
    # the serving path's two shapes (moe-8x40m: 8 experts, top-2)
    assert tgm.pick_block_t(16, 8) == 8      # decode, 8 slots
    assert tgm.pick_block_t(512, 8) == 32    # 256-token prefill chunk


def test_tile_experts_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(25):
        E = int(rng.integers(1, 9))
        bt = int(rng.choice([8, 16, 32]))
        sizes = rng.integers(0, 4, size=E) * bt
        n_tiles = int(sizes.sum() // bt + rng.integers(0, 4))
        ref = np.asarray(jgm.tile_experts(jnp.asarray(sizes, jnp.int32),
                                          n_tiles, bt))
        got = tgm.tile_experts(torch.from_numpy(sizes.astype(np.int32)),
                               n_tiles, bt).numpy()
        np.testing.assert_array_equal(got, ref)
    assert tgm.round_up(16 + 8 * 7, 8) == jgm.round_up(16 + 8 * 7, 8) == 72


def test_gmm_non_cpu_input_raises_instead_of_falling_back():
    # A tensor that is not on the CPU never takes the plain version: on a
    # device the kernel cannot take it raises before any build or launch.
    x = torch.empty((16, 8), device="meta")
    w = torch.empty((2, 8, 8), device="meta")
    gs = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgm.gmm(x, w, gs, 8)


def test_gmm_kernel_path_without_nvcc_raises(monkeypatch, tmp_path):
    # An input that passes the kernel's checks (here: checks waived for a
    # meta tensor standing in for a CUDA one) goes to the build, which
    # raises without nvcc; nothing catches it to run the plain version.
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tgm, "_lib", None)
    monkeypatch.setattr(tgm, "_check", lambda *a: None)
    x = torch.empty((16, 8), device="meta")
    w = torch.empty((2, 8, 8), device="meta")
    gs = torch.empty((2,), dtype=torch.int32, device="meta")
    before = tgm.gmm.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tgm.gmm(x, w, gs, 8)
    assert tgm.gmm.launches == before


# -- the backward: tgmm (dW) and gmm's autograd -------------------------------------
# (block_t, group sizes, tail rows): the training path's tile (128), the
# decode and prefill tiles, empty groups, tail tiles, an empty last expert.
TGMM_CASES = [
    (8, [8, 0, 16, 8], 16),
    (32, [32, 64, 0, 32], 32),
    (128, [128, 0, 256, 128], 128),
    (8, [0, 24, 8, 0], 8),
]


def _tgmm_inputs(sizes, tail, seed=0, K=48, N=40):
    x, _, gs = _inputs(sizes, tail, seed, K, N)
    dy = np.random.default_rng(seed + 100).standard_normal(
        (x.shape[0], N)).astype(np.float32)
    return x, dy, gs


@pytest.mark.parametrize("block_t,sizes,tail", TGMM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_plain_matches_pallas_interpret(block_t, sizes, tail, dtype):
    # The Pallas kernel in interpret mode rounds each tile's fp32 partial to
    # the output type and sums in that type in tile order; tgmm_plain keeps
    # those rounding points. Both compute each fp32 partial with XLA's and
    # torch's CPU matmuls, which here sum in the same order: equal bits
    # (were the partials' orders to differ, a partial could round one bf16
    # ulp apart, and so could the running sum).
    x, dy, gs = _tgmm_inputs(sizes, tail)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    E = len(sizes)
    ref = jgm._tgmm_pallas(jnp.asarray(x, jdt), jnp.asarray(dy, jdt),
                           jnp.asarray(gs), E, block_t, jgm.DEFAULT_BLOCK_N)
    got = tgm.tgmm(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                   torch.from_numpy(gs), E, block_t)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got[e].any(), f"empty expert {e} must be exact zeros"


def test_tgmm_rounding_points_matter_in_bf16():
    # Rounding once after an fp32 sum over the whole group is not the
    # reference: with 8 tiles of 128 rows it moves dW by bf16 ulps.
    x, dy, gs = _tgmm_inputs([1024, 0], 0, K=16, N=8)
    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    tiled = tgm.tgmm_plain(xb, dyb, torch.from_numpy(gs), 2, 128)
    once = (xb.float().t() @ dyb.float()).bfloat16()
    assert (tiled[0] != once).any()
    np.testing.assert_allclose(tiled[0].float().numpy(), once.float().numpy(),
                               rtol=2 ** -5, atol=0.2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_gradients_match_jax_pallas(dtype):
    # Forward, dX and dW through autograd (the custom backward: dX = gmm(dy,
    # w^T), dW = tgmm) against jax.value_and_grad of the Pallas backend's
    # custom VJP, both on the CPU.
    block_t, sizes, tail = 32, [32, 64, 0, 32], 32
    x, w, gs = _inputs(sizes, tail, seed=5)
    g = np.random.default_rng(6).standard_normal((x.shape[0], w.shape[2])) \
        .astype(np.float32)
    # Tail rows are never read back (the dispatcher's contract), so their
    # cotangent is zero; the Pallas backward would otherwise run them
    # against the last expert where the port writes zeros.
    g[sum(sizes):] = 0.0
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    def j_loss(xj, wj):
        out = jgm.gmm(xj, wj, jnp.asarray(gs), block_t=block_t, backend="pallas")
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, j_out), (j_dx, j_dw) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    out = tgm.gmm(xt, wt, torch.from_numpy(gs), block_t)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == tdt
    for got, ref in ((out, j_out), (xt.grad, j_dx), (wt.grad, j_dw)):
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = got.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
        else:
            # one rounding of an fp32 sum (dW: of each tile's partial and
            # the running sum) that a different summation order can move
            # by one bf16 ulp
            np.testing.assert_allclose(got, ref, atol=6e-2, rtol=2 ** -7)


def test_gmm_bf16_precision_matches_jax():
    # model.matmul_precision "bf16" under fp32 operands: both operands cast,
    # the result and its gradients as JAX's gm.gmm(precision="bf16") gives.
    block_t, sizes, tail = 8, [8, 0, 16, 8], 16
    x, w, gs = _inputs(sizes, tail, seed=7)

    def j_fn(xj, wj):
        out = jgm.gmm(xj, wj, jnp.asarray(gs), block_t=block_t,
                      backend="pallas", precision="bf16")
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, j_out), (j_dx, j_dw) = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tgm.gmm(xt, wt, torch.from_numpy(gs), block_t, precision="bf16")
    assert out.dtype == torch.bfloat16 and j_out.dtype == jnp.bfloat16
    (out.float() ** 2).sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=2e-2, rtol=2 ** -7)
    for got, ref in ((xt.grad, j_dx), (wt.grad, j_dw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.3,
                                   rtol=2 ** -6)


def test_gmm_int8_precision_is_refused():
    x, w, gs = _inputs([8, 8], 0)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tgm.gmm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs),
                8, precision="int8")


def test_tgmm_non_cpu_input_raises_instead_of_falling_back():
    x = torch.empty((16, 8), device="meta")
    dy = torch.empty((16, 4), device="meta")
    gs = torch.empty((2,), dtype=torch.int32, device="meta")
    before = tgm.tgmm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgm.tgmm(x, dy, gs, 2, 8)
    assert tgm.tgmm.launches == before


def test_kernel_gate_rejects_a_skipped_tgmm_tile():
    # The gate that holds the tgmm kernel against tgmm_plain on the card, at
    # the training path's tiling on fewer rows: one bf16 ulp of rounding
    # passes; the last expert's last tile left out of the walk does not.
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    rng = np.random.default_rng(8)
    sizes = ((rng.multinomial(4096, [1 / 8] * 8) + 127) // 128 * 128).tolist()
    x, dy, gs = _tgmm_inputs(sizes, 128, K=64, N=64)
    xb, dyb, gst = (torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16(),
                    torch.from_numpy(gs))
    ref = tgm.tgmm_plain(xb, dyb, gst, 8, 128)
    ulp = torch.where(torch.rand(ref.shape, generator=torch.Generator()
                                 .manual_seed(0)) < 0.5, 1.0, -1.0) * 2.0 ** (
        torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    assert kernel_check.compare_experts((ref.float() + ulp).bfloat16(), ref)["ok"]
    bad = kernel_check.tgmm_skipping_a_tile(xb, dyb, gst, 8, 128)
    check = kernel_check.compare_experts(bad, ref)
    assert not check["ok"] and check["limit_ratio"] > 2, check


# -- which kernel a CUDA call launches ------------------------------------------------
# (dtype, block_t, K, N, aligned, gmm's kernel, tgmm's kernel): the MoE training
# path's shapes (moe-8x40m gate/up and down, block_t 128) and block_t 64 take the
# TMA/wgmma kernels; fp32, block_t < 64, K or N not a multiple of 8 and a
# misaligned operand do not.
VARIANT_CASES = [
    ("bfloat16", 128, 512, 1536, True, "wgmma", "wgmma"),
    ("bfloat16", 128, 1536, 512, True, "wgmma", "wgmma"),
    ("bfloat16", 64, 200, 72, True, "wgmma", "wgmma"),
    ("bfloat16", 256, 512, 1536, True, "wgmma", "wgmma"),
    ("bfloat16", 32, 512, 1536, True, "wmma", "wmma"),
    ("bfloat16", 8, 512, 1536, True, "wmma", "wmma"),
    ("bfloat16", 96, 512, 1536, True, "wmma", "wmma"),
    ("bfloat16", 128, 100, 1536, True, "wmma", "wmma"),
    ("bfloat16", 128, 512, 36, True, "wmma", "wmma"),
    ("bfloat16", 128, 512, 1536, False, "wmma", "wmma"),
    ("float32", 128, 512, 1536, True, "f32", "f32"),
    ("float32", 32, 512, 1536, True, "f32", "f32"),
    ("float32", 16, 1536, 512, True, "f32", "f32"),
    ("float32", 64, 200, 72, False, "f32", "f32"),
    ("float32", 8, 512, 1536, True, "f32_decode", "f32"),
    ("float32", 8, 100, 36, False, "f32_decode", "f32"),
]


@pytest.mark.parametrize("dtype,block_t,K,N,aligned,want_gmm,want_tgmm", VARIANT_CASES)
def test_kernel_variant_choice(dtype, block_t, K, N, aligned, want_gmm, want_tgmm):
    dt = getattr(torch, dtype)
    assert tgm.gmm_variant(dt, block_t, K, N, aligned) == want_gmm
    assert tgm.tgmm_variant(dt, block_t, K, N, aligned) == want_tgmm
    assert want_gmm in tgm.GMM_VARIANTS and want_tgmm in tgm.TGMM_VARIANTS


def test_kernel_variant_alignment_and_forcing():
    # A contiguous view that starts 2 bytes into its buffer breaks TMA's
    # 16-byte address rule; fresh tensors meet it.
    buf = torch.zeros(66 * 64 + 8, dtype=torch.bfloat16)
    view = buf[1:1 + 66 * 64].view(66, 64)
    assert view.is_contiguous() and not tgm._aligned(view)
    assert tgm._aligned(torch.zeros(64, 64, dtype=torch.bfloat16))
    assert tgm.gmm_variant(torch.bfloat16, 64, 64, 64, tgm._aligned(view)) == "wmma"
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tgm.gmm_variant(torch.float16, 128, 512, 512)
    # Nothing forces a kernel: the CUDA wrappers take no variant option, so
    # the operands alone pick the kernel that serves a call.
    for fn in (tgm._gmm_forward, tgm.tgmm):
        assert "variant" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("w_trans", [False, True])
def test_kernel_gate_rejects_a_skipped_gmm_tile(w_trans):
    # The gate that holds gmm's kernels against gmm_plain on the card, at the
    # training path's tiling (block_t 128, 8 experts) on fewer rows and
    # narrower widths: one bf16 ulp of rounding passes; the last live row
    # tile left out (its rows zero) does not.
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check

    rng = np.random.default_rng(9)
    sizes = ((rng.multinomial(4096, [1 / 8] * 8) + 127) // 128 * 128).tolist()
    x, w, gs = _inputs(sizes, 128, seed=9, K=64, N=48)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    if w_trans:
        wb = wb.transpose(1, 2).contiguous()  # [E, N, K], read transposed
    gst = torch.from_numpy(gs)
    ref = tgm.gmm_plain(xb, wb.transpose(1, 2) if w_trans else wb, gst, 128)
    assert torch.equal(tgm._gmm_forward(xb, wb, gst, 128, w_trans), ref)
    ulp = torch.where(torch.rand(ref.shape, generator=torch.Generator()
                                 .manual_seed(0)) < 0.5, 1.0, -1.0) * 2.0 ** (
        torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    assert kernel_check.compare((ref.float() + ulp).bfloat16(), ref)["ok"]
    bad = kernel_check.gmm_skipping_a_tile(xb, wb, gst, 128, w_trans)
    live = int(gst.sum())
    assert not bad[live - 128:live].any() and torch.equal(bad[:live - 128], ref[:live - 128])
    check = kernel_check.compare(bad, ref)
    assert not check["ok"] and check["limit_ratio"] > 2, check


# -- the fp32 decode kernel's plan ------------------------------------------------------
@pytest.mark.parametrize("K,N,want", [(512, 1536, (128, 4)), (1536, 512, (128, 12))])
def test_decode_plan_at_the_serving_shapes(K, N, want):
    # moe-8x40m decode: 8 slots x top-2 in a 72-row buffer (nine 8-row tiles);
    # 432 work items of 128 x 128 weights (64 KB) at gate/up and at down,
    # about 4 per SM of an H100 even with two tail tiles.
    kc, chunks = tgm.decode_plan(72, K, N)
    assert (kc, chunks) == want
    assert 9 * chunks * -(-N // 128) == 432


@pytest.mark.parametrize("T", [8, 72, 200, 4096, 80000])
@pytest.mark.parametrize("K,N", [(512, 1536), (1536, 512), (200, 72), (8, 8), (8192, 36)])
def test_decode_plan_chunks_cover_k_once(T, K, N):
    # kc: a multiple of 64 within the kernel's shared-memory slice of x, the
    # smallest whose evenly divided K makes at most 4 x 132 items; the
    # chunks tile [0, K) without overlap or gap.
    kc, chunks = tgm.decode_plan(T, K, N)
    assert kc % 64 == 0 and 64 <= kc <= tgm._DEC_KC_MAX
    assert chunks == -(-K // kc) and (chunks - 1) * kc < K <= chunks * kc
    covered = np.zeros(K, np.int64)
    for c in range(chunks):
        covered[c * kc:min(K, (c + 1) * kc)] += 1
    assert (covered == 1).all()
    work = (T // 8) * -(-N // 128) * K  # weight rows x strips over all tiles
    cap = min(tgm._DEC_KC_MAX, tgm.round_up(K, 64))
    assert kc == cap or work <= kc * tgm._DEC_CTAS
    assert kc == 64 or work > (kc - 64) * tgm._DEC_CTAS


def test_decode_plan_constants_match_the_cuda_source():
    import re

    src = (tgm._SRC).read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (tgm._DEC_ROWS, tgm._DEC_COLS, tgm._DEC_KC_MAX) == (
        const["DEC_ROWS"], const["DEC_COLS"], const["DEC_KC_MAX"])
    assert const["DEC_COLS"] == 4 * 32  # four columns per lane of one warp
