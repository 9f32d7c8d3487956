"""The torch port's MoE training path against the JAX package's, on the CPU.

The MoE block (grouped and einsum dispatch) with its router losses, routing
stats and gradients; a tiny MoE model's loss and gradients; five train
steps; the flops accounting; and a trainer run whose checkpoint the JAX
package loads. The JAX side runs its grouped GEMM as the Pallas kernels in
interpret mode (``GMM_BACKEND=pallas``: ``_gmm_pallas`` forward and dX,
``_tgmm_pallas`` dW); the port runs the kernels' plain versions under its
custom backward. Weights and inputs are numpy from a seed, carried into the
port with ``convert.params_from_jax``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.models import moe as jmoe
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu.train.trainer import (
    load_trained as j_load_trained,
)
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.models import moe as tmoe
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.train import train_step as tts
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import (
    load_trained as t_load_trained,
)

from test_torch_train import (
    _batch,
    _config_dict,
    _flat_grads,
    _random_params,
    _step_losses,
    _torch_batch,
    _torch_flat,
)

E, K = 4, 2


@pytest.fixture(autouse=True)
def _pallas_gmm(monkeypatch):
    # The JAX grouped GEMM as its TPU kernels, in interpret mode.
    monkeypatch.setenv("GMM_BACKEND", "pallas")


def _moe_config(tmp_path, impl="grouped", **moe):
    d = _config_dict(tmp_path, name=f"tiny-moe-{impl}")
    d["model"]["moe"] = {"num_local_experts": E, "num_experts_per_tok": K,
                         "impl": impl, "aux_loss_weight": 0.01,
                         "router_z_weight": 0.001, "capacity_factor": 1.25,
                         "group_size": 16, **moe}
    return d


def _args(d, vocab=259):
    return (jl.LlamaArgs.from_config(JConfig.from_dict(d).model, vocab),
            tl.LlamaArgs.from_config(TConfig.from_dict(d).model, vocab))


def test_moe_args_map_as_jax_does(tmp_path):
    fields = ("num_local_experts", "num_experts_per_tok", "moe_capacity_factor",
              "moe_aux_weight", "router_z_weight", "moe_group_size", "moe_impl",
              "moe_ep_capacity_factor", "matmul_precision")
    for moe in ({}, {"aux_loss_weight": 0, "capacity_factor": None,
                     "group_size": 0, "ep_capacity_factor": 1.5},
                {"aux_loss_weight": None, "router_z_weight": None}):
        d = _moe_config(tmp_path, impl="einsum")
        d["model"]["moe"].update(moe)
        for k in [k for k, v in moe.items() if v is None]:
            del d["model"]["moe"][k]
        jargs, targs = _args(d)
        for f in fields:
            assert getattr(targs, f) == getattr(jargs, f), (moe, f)
    # an absent aux_loss_weight reads 0.01; a zero one reads 0.0
    d = _config_dict(tmp_path)
    d["model"]["moe"] = {"num_local_experts": 4, "num_experts_per_tok": 2}
    assert _args(d)[1].moe_aux_weight == 0.01
    d["model"]["moe"]["aux_loss_weight"] = 0
    assert _args(d)[1].moe_aux_weight == 0.0


def _moe_inputs(jargs, seed):
    np_params = _random_params(jargs, seed)
    ff = np_params["layers"][0]["feed_forward"]
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 24, jargs.hidden_size)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return ff, x, g


@pytest.mark.parametrize("impl,capacity", [("grouped", 1.25), ("einsum", 1.25),
                                           ("einsum", 0.5)])
def test_moe_block_out_aux_stats_and_grads_match_jax(tmp_path, impl, capacity):
    # fp32; the einsum cases at capacity 1.25 and at 0.5, where selections
    # are dropped (and counted).
    jargs, targs = _args(_moe_config(tmp_path, impl, capacity_factor=capacity))
    ff, x, g = _moe_inputs(jargs, seed=11)

    def j_fn(p, xj):
        with jmoe.routing_stats_tap() as tap:
            out, aux = jmoe.moe_block(p, xj, jargs)
        return jnp.sum(out * g) + aux, (out, aux, tap[0])

    (_, (j_out, j_aux, j_stats)), (j_gp, j_gx) = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, ff), jnp.asarray(x))

    tp = params_from_jax(ff, "cpu")
    for leaf in _torch_flat(tp).values():
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    stats = []
    out, aux = tmoe.moe_block(tp, xt, targs, stats)
    ((out * torch.from_numpy(g)).sum() + aux).backward()

    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **tol)
    np.testing.assert_allclose(float(aux), float(j_aux), **tol)
    assert len(stats) == 1
    np.testing.assert_array_equal(stats[0]["moe_load"].numpy(),
                                  np.asarray(j_stats["moe_load"]))
    assert float(stats[0]["moe_dropped"]) == float(j_stats["moe_dropped"])
    if impl == "einsum" and capacity < 1:
        assert float(stats[0]["moe_dropped"]) > 0
    elif impl == "grouped":
        assert float(stats[0]["moe_dropped"]) == 0
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx), **tol)
    jg = _flat_grads(j_gp)
    tg = {k: v.grad.numpy() for k, v in _torch_flat(tp).items()}
    assert jg.keys() == tg.keys()
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(jg[name]).max(), err_msg=name)


def test_moe_block_bf16_matmul_precision_matches_jax(tmp_path):
    # model.matmul_precision "bf16" under fp32 compute: each grouped GEMM
    # casts its operands to bf16 (the port ran them in fp32 before).
    d = _moe_config(tmp_path)
    d["model"]["matmul_precision"] = "bf16"
    jargs, targs = _args(d)
    assert targs.matmul_precision == jargs.matmul_precision == "bf16"
    ff, x, _ = _moe_inputs(jargs, seed=12)
    j_out, _ = jmoe.moe_block(jax.tree_util.tree_map(jnp.asarray, ff),
                              jnp.asarray(x), jargs)
    out, _ = tmoe.moe_block(params_from_jax(ff, "cpu"), torch.from_numpy(x), targs)
    fp32_out, _ = tmoe.moe_block(params_from_jax(ff, "cpu"), torch.from_numpy(x),
                                 dataclasses.replace(targs, matmul_precision=None))
    assert out.dtype == torch.float32
    out, fp32_out, j_out = out.numpy(), fp32_out.numpy(), np.asarray(j_out)
    # Both sides round each GEMM's result to bf16 at the same points (the
    # gmm outputs agree bit for bit), but XLA's CPU silu in bf16 rounds
    # differently from torch's on ~40% of elements, so the block's outputs
    # agree to bf16 noise: a few ulps per element, 1e-2 normwise.
    np.testing.assert_allclose(out, j_out, atol=8e-2, rtol=2e-2)
    assert np.linalg.norm(out - j_out) < 1e-2 * np.linalg.norm(j_out)
    # The precision is applied: fp32 GEMMs give another result.
    assert np.linalg.norm(out - fp32_out) > 1e-3 * np.linalg.norm(fp32_out)


LOGITS_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _model_loss_and_grads(jargs, targs, np_params, batch, dtype, include_aux):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")

    def j_loss(p):
        return jl.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jargs,
                          compute_dtype=jdt, include_aux=include_aux)

    (j_val, _), j_grads = jax.value_and_grad(j_loss, has_aux=True)(jp)
    for leaf in _torch_flat(tp).values():
        leaf.requires_grad_(True)
    t_val, _ = tl.loss_fn(tp, _torch_batch(batch), targs, compute_dtype=tdt,
                          include_aux=include_aux)
    t_val.backward()
    return ((float(j_val), _flat_grads(j_grads)),
            (float(t_val), {k: v.grad.numpy() for k, v in _torch_flat(tp).items()}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_model_loss_and_grads_match_jax(tmp_path, dtype):
    # A 2-layer MoE model with flash attention: logits, the aux losses, the
    # loss with and without aux, and every leaf's gradient.
    jargs, targs = _args(_moe_config(tmp_path))
    np_params = _random_params(jargs, seed=13)
    batch = _batch(14)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_logits, _, j_aux = jl.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                                    jnp.asarray(batch["inputs"]), jargs,
                                    compute_dtype=jdt, return_aux=True)
    with torch.no_grad():
        t_logits, _, t_aux = tl.forward(params_from_jax(np_params, "cpu"),
                                        torch.from_numpy(batch["inputs"]), targs,
                                        compute_dtype=tdt, return_aux=True)
    t_logits, j_logits = t_logits.numpy(), np.asarray(j_logits)
    if dtype == "float32":
        np.testing.assert_allclose(t_logits, j_logits, **LOGITS_TOL[dtype])
        np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)
    else:
        # bf16 noise (XLA's CPU silu rounds unlike torch's) can flip a
        # token whose top-2 router probabilities nearly tie into another
        # expert in the next layer: that token's logits move by up to ~0.4
        # and the top-1 shares in the aux loss by 1/256. Every other token
        # is held to the dense test's limit.
        close = np.isclose(t_logits, j_logits, **LOGITS_TOL[dtype]).all(-1)
        assert close.mean() >= 0.98, (~close).sum()
        np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=5e-3)
    assert float(t_aux) > 0

    losses = {}
    for include_aux in (True, False):
        (j_val, jg), (t_val, tg) = _model_loss_and_grads(
            jargs, targs, np_params, batch, dtype, include_aux)
        losses[include_aux] = t_val
        np.testing.assert_allclose(t_val, j_val,
                                   rtol=1e-5 if dtype == "float32" else 1e-4)
        assert jg.keys() == tg.keys()
        if dtype == "float32":
            for name in jg:
                np.testing.assert_allclose(tg[name], jg[name], rtol=1e-5,
                                           atol=1e-5 * np.abs(jg[name]).max(),
                                           err_msg=name)
            continue
        # bf16: the port's gradients nearer JAX's bf16 gradients than JAX's
        # are to its own fp32 ones (as the dense test holds them).
        (_, jg32), _ = _model_loss_and_grads(jargs, targs, np_params, batch,
                                             "float32", include_aux)
        for name in jg:
            to_jax = np.linalg.norm(tg[name] - jg[name])
            jax_to_fp32 = np.linalg.norm(jg[name] - jg32[name])
            assert to_jax < 0.75 * jax_to_fp32, (name, to_jax, jax_to_fp32)
    np.testing.assert_allclose(losses[True] - losses[False], float(t_aux),
                               rtol=1e-3)


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_train_step_matches_jax(tmp_path, accum):
    d = _moe_config(tmp_path)
    d["training"]["hyperparameters"]["learning_rate"] = 6e-4
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jargs, targs = _args(d)
    np_params = _random_params(jargs, seed=15)
    j_opt = jfactory.build_optimizer(jcfg.training, 20)
    t_opt = tfactory.build_optimizer(tcfg.training, 20)

    def j_loss(p, b):
        return jl.loss_fn(p, b, jargs, compute_dtype=jnp.float32, with_moe_stats=True)

    def t_loss(p, b):
        return tl.loss_fn(p, b, targs, compute_dtype=torch.float32,
                          with_moe_stats=True)

    j_step, _ = jts.make_train_step(j_loss, j_opt, accum_steps=accum,
                                    log_grad_norm=True, moe_stats_experts=E)
    t_step = tts.make_train_step(t_loss, t_opt, accum_steps=accum,
                                 log_grad_norm=True, moe_stats_experts=E)
    js = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, np_params), j_opt)
    ts = tts.init_train_state(params_from_jax(np_params, "cpu"), t_opt)
    j_losses, t_losses = [], []
    for i in range(5):
        batch = _batch(20 + i)
        js, jm = j_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = t_step(ts, _torch_batch(batch))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        # 4 x 64 tokens x top-2 x 2 layers selections, each counted once
        assert float(tm["moe_load"].sum()) == 4 * 64 * K * 2
        np.testing.assert_array_equal(tm["moe_load"].numpy(),
                                      np.asarray(jm["moe_load"]))
        assert float(tm["moe_dropped"]) == float(jm["moe_dropped"]) == 0.0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    jf = _flat_grads(js["params"])
    for key, t in _torch_flat(ts["params"]).items():
        t = t.detach().numpy()
        # as the dense test: entries whose gradients sit at zero may take
        # Adam steps of either sign (at most lr each)
        assert np.isclose(t, jf[key], rtol=1e-5, atol=1e-6).mean() > 0.995, key
        np.testing.assert_allclose(t, jf[key], atol=6e-4, err_msg=key)


def test_moe_flops_count_active_params(tmp_path):
    from mlx_cuda_distributed_pretraining_tpu.obs import flops as jflops
    from mlx_cuda_distributed_pretraining_tpu_torch.obs import flops as tflops

    d = _moe_config(tmp_path)
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    n = 70_000
    want = jflops.model_flops_per_token(jcfg.model, n, 64)
    assert tflops.model_flops_per_token(tcfg.model, n, 64) == want
    # 2 layers x 2 inactive experts x 3 matrices of 32 x 64
    assert tflops.moe_active_params(n, 2, 32, 64, 4, 2) == n - 2 * 2 * 3 * 32 * 64
    # moe-8x40m: 239,269,888 parameters, 69,400,576 of them active
    assert tflops.moe_active_params(239_269_888, 12, 512, 1536, 8, 2) == \
        jflops.moe_active_params(239_269_888, 12, 512, 1536, 8, 2) == 69_400_576


@pytest.mark.parametrize("impl", ["grouped", "einsum"])
def test_moe_trainer_runs_and_its_run_loads_in_jax(tmp_path, impl):
    d = _moe_config(tmp_path, impl)
    d["training"]["hyperparameters"]["iters"] = 10
    d["logging"]["steps"].update(checkpoint_interval=0, validation_interval=5)
    d["system"]["mesh"] = {"dp": -1}  # resolves to the one device
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"),
                 quiet=True, device="cpu")
    result = tr.train()
    assert result["steps"] == 10
    log = open(os.path.join(tr.run_dir, "log.txt")).read()
    steps = _step_losses(log)
    assert [s for s, _ in steps] == [5, 10]
    assert steps[-1][1] < steps[0][1]
    for line in (ln for ln in log.splitlines() if ln.startswith("Step")
                 and "validation" not in ln):
        fields = dict(kv.split("=") for kv in line.split(": ", 1)[1].split(" | "))
        assert 0.0 < float(fields["moe_entropy"]) <= 1.0
        assert 1.0 / E <= float(fields["moe_load_max"]) <= 1.0
        assert int(fields["moe_drop"]) >= 0 if impl == "einsum" \
            else int(fields["moe_drop"]) == 0
    # validation is pure cross-entropy: the eval loss leaves out aux
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(tr.data.iter_validation(1))).items()}
    with_aux, _ = tl.loss_fn(tr.state["params"], batch, tr.model_args)
    val, _ = tr.eval_step(tr.state["params"], batch)
    assert float(val) < float(with_aux)

    jp, jargs, jtok, _ = j_load_trained(tr.run_dir)
    tp, targs, ttok, _ = t_load_trained(tr.run_dir, device="cpu")
    assert jargs.moe_impl == targs.moe_impl == impl and targs.is_moe
    prompt = [ttok.bos_id] + ttok.tokenize("the quick brown fox")
    j_logits, _ = jl.forward(jp, jnp.asarray([prompt], jnp.int32), jargs)
    with torch.no_grad():
        t_logits, _ = tl.forward(tp, torch.tensor([prompt]), targs)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-5, rtol=1e-5)


def test_moe_trainer_refuses_int8_grouped_gemms(tmp_path):
    # int8 grouped GEMMs are ported (tests/test_torch_int8_train.py trains
    # them): the trainer builds; model parallelism (a tp axis, ROADMAP item
    # 10a: tests/test_torch_tp_train.py) needs its ranks, and one rank
    # names the launcher
    d = _moe_config(tmp_path)
    d["model"]["matmul_precision"] = "int8"
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r"), quiet=True,
                 device="cpu")
    assert tr.model_args.matmul_precision == "int8"
    d["system"]["model_parallel"] = True
    d["system"]["model_parallel_size"] = 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1.*parallel.launch"):
        Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r"), quiet=True,
                device="cpu")
