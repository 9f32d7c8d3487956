"""The port's Muon against the JAX package's, on the CPU.

Newton-Schulz-5 on tall, wide, square and stacked inputs (fp32: summation
order only, 1e-5 relative); the label functions by path; the batched
iteration over same-shape leaves against one matrix at a time (1e-6
relative: a batched product may sum in another order than a single one);
and five train steps of a tiny Muon config, losses and gradient norms
within 1e-5 relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.train import train_step as tts

from test_torch_train import _args, _batch, _config_dict, _random_params, _torch_batch

jmuon = importlib.import_module("mlx_cuda_distributed_pretraining_tpu.optim.muon")
tmuon = importlib.import_module("mlx_cuda_distributed_pretraining_tpu_torch.optim.muon")


@pytest.mark.parametrize("shape", [(48, 16), (16, 48), (32, 32), (3, 40, 24), (2, 2, 8, 12)])
def test_newton_schulz5_matches_jax(shape):
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if len(shape) == 2:
        j = np.asarray(jmuon.newton_schulz5(jnp.asarray(g)))
    else:  # JAX orthogonalizes a stacked leaf one trailing matrix at a time
        flat = jnp.asarray(g.reshape((-1,) + shape[-2:]))
        j = np.asarray(jax.vmap(jmuon.newton_schulz5)(flat)).reshape(shape)
    t = tmuon.newton_schulz5(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
    # orthogonal: the singular values of a 5-step NS5 land in about [0.7, 1.2]
    sv = np.linalg.svd(t.reshape((-1,) + shape[-2:]), compute_uv=False)
    assert sv.min() > 0.5 and sv.max() < 1.3


def test_batched_ns_equals_per_matrix_ns():
    """``orthogonalize`` stacks same-shape leaves (the tall one transposed)
    into one batched iteration: each matrix's result equals the per-matrix
    :func:`newton_schulz5` times its RMS scale."""
    rng = np.random.default_rng(1)
    tree = {"a": torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32)),
            "b": [torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)),
                  torch.from_numpy(rng.standard_normal((3, 16, 40)).astype(np.float32))],
            "c": torch.from_numpy(rng.standard_normal((24, 24)).astype(np.float32)),
            "gone": None}
    out = tmuon.orthogonalize(tree)
    assert out["gone"] is None
    for got, x in ((out["a"], tree["a"]), (out["b"][0], tree["b"][0]),
                   (out["b"][1], tree["b"][1]), (out["c"], tree["c"])):
        want = tmuon.newton_schulz5(x) * np.sqrt(max(1.0, x.shape[-2] / x.shape[-1]))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_label_functions_match_jax():
    jargs = jl.LlamaArgs(vocab_size=259, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                         tie_word_embeddings=False, attention_bias=True)
    np_params = jax.tree_util.tree_map(np.asarray, jl.init_params(jax.random.PRNGKey(0), jargs))
    tp = params_from_jax(np_params, "cpu")
    for jfn, tfn in ((jmuon.matrix_label_fn, tmuon.matrix_label_fn),
                     (jmuon.embedding_rest_label_fn, tmuon.embedding_rest_label_fn)):
        j = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(jfn(np_params))}
        t = tfn(tp)
        assert t["output"]["weight"] == j["['output']['weight']"]
        assert t["layers"][1]["attention"]["wq"]["bias"] == "rest"
        flat = {}

        def walk(x, prefix=""):
            if isinstance(x, dict):
                for k, v in x.items():
                    walk(v, f"{prefix}['{k}']")
            elif isinstance(x, list):
                for i, v in enumerate(x):
                    walk(v, f"{prefix}[{i}]")
            else:
                flat[prefix] = x

        walk(t)
        assert flat == j
    assert tmuon.embedding_rest_label_fn(tp)["tok_embeddings"]["weight"] == "rest"
    assert tmuon.matrix_label_fn(tp)["tok_embeddings"]["weight"] == "matrix"


def test_five_muon_train_steps_match_jax(tmp_path):
    d = _config_dict(tmp_path)
    d["training"]["optimization"] = {"optimizer": "muon", "momentum": 0.95,
                                     "nesterov": True, "ns_steps": 5,
                                     "adamw_lr_ratio": 0.04}
    d["training"]["hyperparameters"]["learning_rate"] = 2e-2
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jargs, targs = _args(d)
    np_params = _random_params(jargs, seed=4)
    j_opt = jfactory.build_optimizer(jcfg.training, 20)
    t_opt = tfactory.build_optimizer(tcfg.training, 20)
    j_step, _ = jts.make_train_step(
        lambda p, b: jl.loss_fn(p, b, jargs, compute_dtype=jnp.float32), j_opt,
        log_grad_norm=True)
    t_step = tts.make_train_step(
        lambda p, b: tl.loss_fn(p, b, targs, compute_dtype=torch.float32), t_opt,
        log_grad_norm=True)
    js = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, np_params), j_opt)
    ts = tts.init_train_state(params_from_jax(np_params, "cpu"), t_opt)
    j_losses, t_losses = [], []
    for i in range(5):
        batch = _batch(10 + i)
        js, jm = j_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = t_step(ts, _torch_batch(batch))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
