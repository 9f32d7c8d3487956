"""The port's flex path against the JAX package's, on the CPU.

``flex_attention`` with the ALiBi and soft-cap score mods under causal,
sliding-window, prefix-LM and band masks, GQA, head dims 16, 32 and 64:
the port runs the kernels' plain versions under its custom backward, JAX
its Pallas kernels in interpret mode (64-row blocks, S 128: 2 x 2 tiles).
fp32: the output and dQ, dK, dV within 1e-5 of the largest entry (the two
sides sum in different orders). Also the band planners at the kernels'
tiles, a tiny 1m-flex-shaped model's loss and gradients, and the head
dims the kernels' checks accept (16 and 32 were refused before).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.ops import flash_attention as jf
from mlx_cuda_distributed_pretraining_tpu.ops import flex_attention as jflex
from mlx_cuda_distributed_pretraining_tpu.ops import masks as JM
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as tf
from mlx_cuda_distributed_pretraining_tpu_torch.ops import flex_attention as tflex
from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks as TM

from test_torch_train import (
    _args,
    _batch,
    _config_dict,
    _flat_grads,
    _random_params,
    _torch_batch,
    _torch_flat,
)

S, HQ, HKV, BLOCK = 128, 4, 2, 64
WINDOW, PREFIX, CAP = 40, 50, 2.0
MASKS = {
    "causal": (JM.causal(), TM.causal()),
    "sliding_window": (JM.sliding_window(WINDOW), TM.sliding_window(WINDOW)),
    "prefix_lm": (JM.prefix_lm(PREFIX), TM.prefix_lm(PREFIX)),
    "band": (JM.band(WINDOW), TM.band(WINDOW)),
}
MODS = {
    "alibi": (jflex.alibi_score_fn(HQ), tflex.alibi_score_fn(HQ)),
    "soft_cap": (jflex.soft_cap_score_fn(CAP), tflex.soft_cap_score_fn(CAP)),
}


def _close(t, j, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5,
                               atol=1e-5 * np.abs(j).max(), err_msg=what)


@pytest.mark.parametrize("head_dim", [16, 32, 64])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mod", list(MODS))
def test_flex_attention_forward_and_grads_match_jax(mod, mask, head_dim):
    rng = np.random.default_rng(head_dim)
    q, k, v = (rng.standard_normal((1, S, h, head_dim)).astype(np.float32)
               for h in (HQ, HKV, HKV))
    do = rng.standard_normal((1, S, HQ, head_dim)).astype(np.float32)
    jmask, tmask = MASKS[mask]
    jmod, tmod = MODS[mod]

    def j_loss(q, k, v):
        o = jflex.flex_attention(q, k, v, mask_mod=jmask, score_mod=jmod,
                                 block_q=BLOCK, block_kv=BLOCK)
        return jnp.sum(o * do), o

    (_, j_o), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    t_o = tflex.flex_attention(tq, tk, tv, mask_mod=tmask, score_mod=tmod)
    (t_o * torch.from_numpy(do)).sum().backward()
    _close(t_o, j_o, "o")
    for name, t, j in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), j_grads):
        _close(t, j, name)


@pytest.mark.parametrize("mod", list(MODS))
def test_raw_kernels_plain_versions_match_jax_raw_kernels(mod):
    """The three raw entry points (plain) against JAX's raw Pallas kernels
    with the same score mod, band mask: o, lse, dQ and per-head dK/dV."""
    rng = np.random.default_rng(7)
    q, k, v, do = (rng.standard_normal((1, h, S, 32)).astype(np.float32)
                   for h in (HQ, HKV, HKV, HQ))
    jmod, tmod = MODS[mod]
    score_mod, score_arg = tmod._code
    jkw = dict(mask_fn=JM.band(WINDOW), score_fn=jmod, mask_type="band", window=WINDOW,
               block_q=BLOCK, block_kv=BLOCK, scale=0.3, canonical_mask=True)
    j_o, j_lse = jf.flash_fwd(*map(jnp.asarray, (q, k, v)), **jkw)
    delta = (np.asarray(j_o) * do).sum(-1)[:, :, None, :]
    j_dq = jf.flash_bwd_dq(*map(jnp.asarray, (q, k, v, do)), j_lse, jnp.asarray(delta), **jkw)
    j_dk, j_dv = jf.flash_bwd_dkv(*map(jnp.asarray, (q, k, v, do)), j_lse,
                                  jnp.asarray(delta), **jkw)
    kw = dict(mask_type="band", window=WINDOW, scale=0.3, score_mod=score_mod,
              score_arg=score_arg)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    t_o, t_lse = tf.flash_fwd(*t, **kw)
    _close(t_o, j_o, "o")
    _close(t_lse, np.asarray(j_lse)[:, :, 0], "lse")
    targs = t + [torch.from_numpy(do), torch.from_numpy(np.asarray(j_lse)[:, :, 0].copy()),
                 torch.from_numpy(delta[:, :, 0].copy())]
    _close(tf.flash_bwd_dq(*targs, **kw), j_dq, "dq")
    t_dk, t_dv = tf.flash_bwd_dkv(*targs, **kw)
    _close(t_dk, j_dk, "dk")
    _close(t_dv, j_dv, "dv")


@pytest.mark.parametrize("window", [-40, 0, 1, 100, 300])
def test_band_plans_at_the_kernels_tiles_match_jax(window):
    """``_plan`` builds the kernels' live ranges and no-mask flags from the
    band planners; at every kernel's tiles they are JAX's planners'."""
    for fn, variant, d in (("flash_fwd", "wgmma", 64), ("flash_bwd_dq", "wgmma", 128),
                           ("flash_bwd_dkv", "wgmma", 128), ("flash_bwd_dq", "wgmma", 16),
                           ("flash_bwd_dq", "wgmma", 32), ("flash_fwd", "f32", 64),
                           ("flash_fwd", "f32", 128), ("flash_bwd_dq", "f32", 16)):
        bq, bkv = tf.kernel_tiles(fn, variant, d)
        for s in (128, 1000, 1024):
            kv_ranges, q_ranges, full = tf._plan("band", window, 0, s, bq, "cpu", bkv)
            nq, nk = -(-s // bq), -(-s // bkv)
            jlo, jhi = jf._kv_range("band", window, 0, bq, bkv, nk)
            assert kv_ranges.tolist() == [[int(jlo(i)), int(jhi(i))] for i in range(nq)]
            jlo, jhi = jf._q_range("band", window, 0, bq, bkv, nq)
            assert q_ranges.tolist() == [[int(jlo(j)), int(jhi(j))] for j in range(nk)]
            jfull = jf._full_tile_fn("band", window, 0, bq, bkv)
            assert full.tolist() == [
                [int(bool(jfull(i, j)) and (i + 1) * bq <= s and (j + 1) * bkv <= s)
                 for j in range(nk)] for i in range(nq)]


def test_kernels_accept_the_head_dims_jax_takes():
    """The kernels' checks (plain functions of the operands' metadata)
    accept head dims 16 and 32 as JAX's Pallas kernels do, bf16 and fp32,
    and pick the wgmma forward, dQ and dK/dV there; D 48 stays refused."""
    for d in (16, 32, 64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros((2, 4, 100, d), dtype=dtype)
            k = torch.zeros((2, 2, 100, d), dtype=dtype)
            stats = torch.zeros((2, 4, 100))
            tf.check_operands("flash_bwd_dkv", {"q": q, "k": k, "v": k, "do": q,
                                                "lse": stats, "delta": stats},
                              "band", "soft_cap", 50.0)
            for fn in tf.FLASH_KERNELS:
                want = "f32" if dtype == torch.float32 else "wgmma"
                assert tf.flash_variant(fn, dtype, d) == want
    q = torch.zeros((1, 4, 64, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        tf.check_operands("flash_fwd", {"q": q, "k": q, "v": q}, "causal")
    with pytest.raises(ValueError, match="score mod"):
        tf.check_operands("flash_fwd", {"q": q, "k": q, "v": q}, "causal", "rope")


def test_score_mods_carry_jaxs_arithmetic():
    """The kernel score mods as functions (the plain reference of the
    kernels' codes) equal JAX's on the same lattice."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((16, 24)).astype(np.float32) * 5
    row = np.arange(16)[:, None] + 40
    col = np.arange(24)[None, :]
    for name, (jmod, tmod) in MODS.items():
        for h in range(HQ):
            j = jmod(jnp.asarray(s), jnp.asarray(row), jnp.asarray(col), h)
            t = tmod(torch.from_numpy(s), torch.from_numpy(row), torch.from_numpy(col), h)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    jd = MODS["soft_cap"][0]._d_score(jnp.asarray(s), row, col, 0)
    td = MODS["soft_cap"][1]._d_score(torch.from_numpy(s), row, col, 0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert MODS["alibi"][1]._d_score is None
    np.testing.assert_array_equal(TM.alibi_slopes(6), JM.alibi_slopes(6))


@pytest.mark.parametrize("score_mod", ["alibi", "soft_cap"])
def test_flex_model_loss_and_grads_match_jax(tmp_path, score_mod):
    """A tiny 1m-flex-shaped model (flex attention, sliding window 16,
    head dim 16, GQA) in fp32: loss within 1e-5, gradients within 1e-5 of
    each leaf's largest entry."""
    d = _config_dict(tmp_path)
    d["model"]["attention"] = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
                               "use_flex_attention": True, "mask_type": "sliding_window",
                               "window_size": 16, "score_mod": score_mod, "soft_cap": 3.0}
    jargs, targs = _args(d)
    assert jargs.attention_type == targs.attention_type == "flex"
    np_params = _random_params(jargs, seed=5)
    batch = _batch(3)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: jl.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jargs,
                             compute_dtype=jnp.float32), has_aux=True)(jp)
    tp = params_from_jax(np_params, "cpu")
    for leaf in _torch_flat(tp).values():
        leaf.requires_grad_(True)
    t_loss, _ = tl.loss_fn(tp, _torch_batch(batch), targs, compute_dtype=torch.float32)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    jg = _flat_grads(j_grads)
    for key, leaf in _torch_flat(tp).items():
        _close(leaf.grad, jg[key], key)
