"""The torch port's grouped expert GEMM against the JAX package's.

On the CPU the port's ``gmm`` runs its plain version (the blocked
formulation); it is held against the JAX Pallas kernel run in interpret mode
(``backend="pallas"``), as tests/test_moe.py runs it. The CUDA kernel itself
runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
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
