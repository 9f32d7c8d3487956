"""The torch port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(the kernels have no CPU mode). The file imports torch only, so on a machine
without JAX it runs with the repository's conftest switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

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
