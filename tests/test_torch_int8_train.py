"""``model.matmul_precision: int8`` in the torch port against the JAX
package, on the CPU: the int8 grouped GEMM (JAX's ``_gmm_int8`` with its
straight-through backward), int8-gridded q/k/v over flash attention (JAX's
``quantize_operand_int8``), the model's loss and the trainer; and
``attention_type: ring`` on one device (JAX falls back to the reference
attention when there is no ``sp`` mesh axis).

Inputs are numpy from seeds, weights carried across with
``convert.params_from_jax``. Tolerances: the int8 forwards are exact in
fp32 (the same integer grid, the same exact integer sums, the same
epilogue order; JAX's ``round`` and ``torch.round`` both round half to
even); the fp32 backwards agree to float summation order (1e-5); bf16
outputs to one bf16 ulp where the gradient sums run in another order. The
JAX flash kernels run in Pallas interpret mode, as the JAX package's own
tests run them on the CPU.

JAX-only tests with no counterpart: none of the JAX file's training
cases; its audit and materialization rules read lowered XLA programs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.ops import flash_attention as jfa
from mlx_cuda_distributed_pretraining_tpu.ops import grouped_matmul as jgm
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as tfa
from mlx_cuda_distributed_pretraining_tpu_torch.ops import grouped_matmul as tgm
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

from test_torch_train import _config_dict, _step_losses

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=128)


def _port_args(jargs, **kw):
    fields = {f.name for f in dataclasses.fields(tl.LlamaArgs)}
    return tl.LlamaArgs(**{**{k: v for k, v in dataclasses.asdict(jargs).items()
                              if k in fields}, **kw})


def _gmm_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    w = (rng.normal(size=(4, 64, 96)) * 0.1).astype(np.float32)
    g = rng.normal(size=(256, 96)).astype(np.float32)
    return x, w, np.array([64, 128, 0, 64], np.int32), g


# -- the int8 grouped GEMM ----------------------------------------------------
def test_gmm_int8_precision_fwd_bwd():
    # JAX's test on the port: quantized but close to fp, gradients close
    x, w, gs, _ = _gmm_inputs()
    xt, wt, gst = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs)
    y_fp = tgm.gmm(xt, wt, gst, 64)
    y_q = tgm.gmm(xt, wt, gst, 64, precision="int8")
    rel = float((y_q - y_fp).norm() / y_fp.norm())
    assert 0 < rel < 0.02

    def grads(prec):
        a, b = xt.clone().requires_grad_(), wt.clone().requires_grad_()
        (tgm.gmm(a, b, gst, 64, precision=prec) ** 2).sum().backward()
        return a.grad, b.grad

    for a, b in zip(grads("int8"), grads(None)):
        assert float((a - b).norm() / b.norm()) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_int8_forward_and_backward_match_jax(dtype):
    x, w, gs, g = _gmm_inputs(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)

    def jloss(a, b):
        y = jgm.gmm(a, b, jnp.asarray(gs), block_t=64, precision="int8")
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), y

    (_, yj), (gxj, gwj) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(xj, wj)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    yt = tgm.gmm(xt, wt, torch.from_numpy(gs), 64, precision="int8")
    (yt.float() * torch.from_numpy(g)).sum().backward()
    assert yt.dtype == xt.grad.dtype == wt.grad.dtype == tdt
    # the forward is exact in either dtype: equal integer sums, equal epilogue
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(yj, np.float32))
    # dW sums the tiles in fp32 (the fp32 tgmm); an empty expert is zero
    np.testing.assert_allclose(wt.grad.float().numpy(), np.asarray(gwj, np.float32), **TOL)
    assert not wt.grad[2].any()
    # dX runs the gmm in dy's dtype: one bf16 rounding of the same sums
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(gxj, np.float32), **tol)


def test_gmm_int8_dw_sums_tiles_in_fp32_not_bf16():
    # bf16 operands: the fp32 tile sums (JAX's int8 backward) against the
    # bf16 tgmm's rounded partials, which would differ
    x, w, gs, g = _gmm_inputs(2)
    xt = torch.from_numpy(x).bfloat16()
    dy = torch.from_numpy(g).bfloat16()
    gst = torch.from_numpy(gs)
    fp32_sum = tgm.tgmm(xt.float(), dy.float(), gst, 4, 64)
    bf16_tiles = tgm.tgmm(xt, dy, gst, 4, 64)
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    tgm.gmm(xt, wt, gst, 64, precision="int8").backward(dy)
    np.testing.assert_array_equal(wt.grad.float().numpy(), fp32_sum.bfloat16().float().numpy())
    assert (fp32_sum.bfloat16() != bf16_tiles).any()


def test_gmm_int8_products_are_exact_integer_sums():
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, size=(64, 1536)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(2, 1536, 40)).astype(np.int8)
    gs = np.array([32, 16], np.int32)
    acc = tgm.gmm_int8_products(torch.from_numpy(xq), torch.from_numpy(wq),
                                torch.from_numpy(gs), 16).numpy()
    want = np.zeros((64, 40), np.int64)
    want[:32] = xq[:32].astype(np.int64) @ wq[0].astype(np.int64)
    want[32:48] = xq[32:48].astype(np.int64) @ wq[1].astype(np.int64)
    np.testing.assert_array_equal(acc, want)  # rows past the groups: zero
    assert acc.dtype == np.int32


def test_gmm_int8_quantizers_match_jax():
    x, w, _, _ = _gmm_inputs(4)
    for tq_, js in ((tgm._quantize_rows_int8(torch.from_numpy(x)), jgm._quantize_rows_int8(x)),
                    (tgm._quantize_cols_int8(torch.from_numpy(w)), jgm._quantize_cols_int8(w))):
        for a, b in zip(tq_, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gmm_int8_kernel_row_tile():
    assert [tgm.gmm_int8_bm(b) for b in (16, 32, 64, 128)] == [16, 32, 64, 64]
    assert [tgm.gmm_int8_bm(b, "wgmma") for b in (64, 128, 256)] == [64, 128, 128]
    with pytest.raises(ValueError, match="block_t"):
        tgm.gmm_int8_bm(8)
    with pytest.raises(ValueError, match="CUDA"):
        tgm.gmm_int8_kernel(torch.zeros(16, 64, dtype=torch.int8), torch.ones(16, 1),
                            torch.zeros(1, 64, 8, dtype=torch.int8), torch.ones(1, 1, 8),
                            torch.tensor([16], dtype=torch.int32), 16, torch.float32)


@pytest.mark.parametrize("block_t,N,aligned,want", [
    (128, 1536, True, "wgmma"),      # the MoE training path: 128-row wgmma tiles
    (64, 512, True, "wgmma"),
    (256, 72, True, "wgmma"),
    (32, 1536, True, "mma_sync"),    # no 64-row wgmma tile inside a 32-row group
    (16, 512, True, "mma_sync"),
    (128, 36, True, "mma_sync"),     # the 16-byte epilogue stores need N % 8 == 0
    (128, 1536, False, "mma_sync"),  # TMA needs 16-byte aligned operands
])
def test_gmm_int8_variant_choice(block_t, N, aligned, want):
    assert tgm.gmm_int8_variant(block_t, N, aligned) == want
    assert want in tgm.GMM_INT8_VARIANTS


def test_gmm_int8_variant_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="block_t"):
        tgm.gmm_int8_variant(8, 512)
    with pytest.raises(ValueError, match="block_t"):
        tgm.gmm_int8_variant(96 + 8, 512)
    tgm.reset_launches()
    assert tgm.gmm_int8.launches_by_variant == {"wgmma": 0, "mma_sync": 0}


# -- int8 over flash attention ------------------------------------------------
def test_flash_attention_precision_modes():
    assert tfa.check_matmul_precision(None) is None
    assert tfa.check_matmul_precision("FP32") is None
    assert tfa.check_matmul_precision("int8") == "int8"
    with pytest.raises(ValueError, match="precision"):
        tfa.check_matmul_precision("fp8")
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 128, 4, 16)).astype(np.float32) for _ in range(3))
    o = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    qt = torch.from_numpy(q).requires_grad_()
    o8 = tfa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v), precision="int8")
    rel = float((o8.detach() - o).norm() / o.norm())
    assert 0 < rel < 0.05
    (o8 ** 2).sum().backward()
    assert torch.isfinite(qt.grad).all()
    # against JAX's int8 flash attention (Pallas interpret mode), forward
    # and the straight-through dQ
    jo8, jvjp = jax.vjp(lambda a: jfa.flash_attention(
        a, jnp.asarray(k), jnp.asarray(v), mask_type="causal", precision="int8"),
        jnp.asarray(q))
    np.testing.assert_allclose(o8.detach().numpy(), np.asarray(jo8), **TOL)
    (jdq,) = jvjp(2 * jo8)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(jdq), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_operand_int8_matches_jax_bitwise(dtype):
    # including the straight-through sum x + (xq - x), evaluated in x's
    # dtype: under bf16 it is not always xq
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 64, 2, 32)) * rng.uniform(0.1, 10, size=(4, 64, 2, 1))
         ).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jfa.quantize_operand_int8(jx), np.float32)
    got = tfa.quantize_operand_int8(tx).float().numpy()
    np.testing.assert_array_equal(got, want)
    # straight through: the gradient is the identity
    tx.requires_grad_()
    tfa.quantize_operand_int8(tx).float().sum().backward()
    assert (tx.grad == 1).all()


# -- the model and the trainer --------------------------------------------------
def test_matmul_precision_loss_parity_vs_bf16():
    # JAX's gate on the port: the int8 loss tracks fp32 within the bf16
    # cast's order of deviation, every gradient finite; and the port's
    # int8 loss is JAX's at fp32 tolerance
    jargs = jl.LlamaArgs(**BASE, attention_type="flash")
    jparams = jl.init_params(jax.random.PRNGKey(0), jargs)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(1).integers(0, BASE["vocab_size"], size=(2, 128))
    tt = torch.from_numpy(toks).long()

    def loss(params, args):
        logits, _ = tl.forward(params, tt, args)
        lse = torch.log_softmax(logits.float(), dim=-1)
        return -lse[:, :-1].gather(-1, tt[:, 1:, None]).mean()

    losses = {}
    for prec in (None, "bf16", "int8"):
        args = _port_args(jargs, matmul_precision=prec)
        leaves = [t.requires_grad_() for t in _leaves(tparams)]
        val = loss(tparams, args)
        val.backward()
        assert all(torch.isfinite(t.grad).all() for t in leaves)
        for t in leaves:
            t.grad = None
        losses[prec] = float(val)
    base = abs(losses[None]) + 1e-12
    dev_bf16 = abs(losses["bf16"] - losses[None]) / base
    dev_int8 = abs(losses["int8"] - losses[None]) / base
    assert dev_int8 < 1e-4
    assert dev_int8 <= max(10.0 * dev_bf16, 1e-5)

    def jloss(p, a):
        logits, _ = jl.forward(p, jnp.asarray(toks, jnp.int32), a)
        lse = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(lse[:, :-1], jnp.asarray(toks)[:, 1:, None], -1))

    j8 = float(jloss(jparams, dataclasses.replace(jargs, matmul_precision="int8")))
    assert abs(losses["int8"] - j8) <= 1e-5 * abs(j8)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_moe_loss_and_grads_match_jax(dtype):
    # a 2-layer MoE model with flash attention under int8: the grouped
    # GEMMs run the int8 path and attention the int8 grid
    jargs = jl.LlamaArgs(**BASE, attention_type="flash", num_local_experts=4,
                         num_experts_per_tok=2, matmul_precision="int8")
    np_params = jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(2), jargs))
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 259, size=(2, 65))
    batch = {"inputs": rows[:, :-1].astype(np.int32), "targets": rows[:, 1:].astype(np.int32),
             "mask": np.ones((2, 64), np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    (jval, _), jgrads = jax.value_and_grad(
        lambda p: jl.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jargs,
                             compute_dtype=jdt), has_aux=True)(jp)
    tp = params_from_jax(np_params, "cpu")
    leaves = [t.requires_grad_() for t in _leaves(tp)]
    tval, _ = tl.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                         _port_args(jargs), compute_dtype=tdt)
    tval.backward()
    rel = 1e-5 if dtype == "float32" else 2e-2
    assert abs(float(tval) - float(jval)) <= rel * abs(float(jval))
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(leaves)
    num = sum(float(np.linalg.norm(t.grad.float().numpy() - np.asarray(j, np.float32)) ** 2)
              for t, j in zip(_leaves_sorted(tp), jleaves))
    den = sum(float(np.linalg.norm(np.asarray(j, np.float32)) ** 2) for j in jleaves)
    assert num ** 0.5 <= (1e-5 if dtype == "float32" else 3e-2) * den ** 0.5


def _leaves_sorted(tree):
    # jax.tree_util's order: dict keys sorted, lists in order
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves_sorted(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves_sorted(v)]
    return [tree]


def test_trainer_trains_moe_at_matmul_precision_int8(tmp_path):
    d = _config_dict(tmp_path, name="tiny-int8", iters=10)
    d["model"]["moe"] = {"num_local_experts": 4, "num_experts_per_tok": 2,
                         "impl": "grouped"}
    d["model"]["matmul_precision"] = "int8"
    d["logging"]["steps"].update(checkpoint_interval=0, validation_interval=0)
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                 device="cpu")
    assert tr.model_args.matmul_precision == "int8"
    tr.train()
    steps = _step_losses(open(f"{tr.run_dir}/log.txt").read())
    assert [s for s, _ in steps] == [5, 10]
    assert all(np.isfinite(l) for _, l in steps) and steps[-1][1] < steps[0][1]


# -- attention_type: ring on one device ------------------------------------------------
@pytest.mark.parametrize("mask", ["causal", "sliding_window"])
def test_ring_attention_without_a_mesh_matches_jax(mask):
    # No sp mesh axis: JAX falls back to the reference attention under the
    # config's mask; the port raised before
    jargs = jl.LlamaArgs(**BASE, attention_type="ring", mask_type=mask, window_size=16)
    jparams = jl.init_params(jax.random.PRNGKey(3), jargs)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(7).integers(0, 259, size=(2, 48)).astype(np.int32)
    jout, _ = jl.forward(jparams, jnp.asarray(toks), jargs)
    with torch.no_grad():
        tout, _ = tl.forward(tparams, torch.from_numpy(toks).long(), _port_args(jargs))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
