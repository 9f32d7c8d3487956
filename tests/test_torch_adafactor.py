"""The port's Adafactor against the JAX package's, on the CPU.

Five steps of each on the same parameters and gradients (numpy from a
seed): parameters and every state leaf, under the JAX flattened names,
within 1e-5 relative; the state's names and shapes (the ``(1,)``
placeholders where a leaf is not factored) identical, so an optimizer file
from either package loads in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.optim.adafactor import _factored_dims as j_factored
from mlx_cuda_distributed_pretraining_tpu.optim.adafactor import adafactor as j_adafactor
from mlx_cuda_distributed_pretraining_tpu.optim import base as jbase
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.optim import schedules as jsched
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch.convert import (
    opt_state_from_jax,
    params_from_jax,
)
from mlx_cuda_distributed_pretraining_tpu_torch.optim.adafactor import _factored_dims as t_factored
from mlx_cuda_distributed_pretraining_tpu_torch.optim.adafactor import adafactor as t_adafactor
from mlx_cuda_distributed_pretraining_tpu_torch.optim import base as tbase
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.optim import schedules as tsched
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict


def _tree(seed):
    """A Llama-shaped tree: the [V, D] = [256, 2048] embedding and a
    [D, 160] projection are factored, a [64, 96] matrix is not (96 and 64
    are under 128), norm gains are vectors."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=0.05):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return {
        "tok_embeddings": {"weight": n(256, 2048)},
        "layers": [{"attention": {"wq": {"weight": n(2048, 160)}},
                    "attention_norm": {"weight": 1.0 + n(2048)},
                    "feed_forward": {"w_up": {"weight": n(64, 96)}}}],
        "norm": {"weight": 1.0 + n(2048)},
    }


OPTIONS = [
    dict(grad_clip=1.0),
    dict(weight_decay=0.1, momentum=0.9, clipping_threshold=None,
         multiply_by_parameter_scale=False),
]


def _run_both(opts, steps=5):
    j_sched = jsched.warmup_cosine(1e-2, 10, 2, 1e-3)
    t_sched = tsched.warmup_cosine(1e-2, 10, 2, 1e-3)
    jopt = j_adafactor(j_sched, **opts)
    topt = tbase.in_place(t_adafactor(t_sched, **opts))
    np_params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for step in range(steps):
        grads = jax.tree_util.tree_map(lambda x: x * 3.0, _tree(100 + step))
        u, js = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        jp = jbase.apply_updates(jp, u)
        tp, ts = topt.fused_apply(params_from_jax(grads, "cpu"), ts, tp)
    return jp, js, tp, ts


def _host(tree):
    return jflatten(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("opts", OPTIONS, ids=["clip", "wd_momentum"])
def test_adafactor_five_steps_match_jax_leaf_for_leaf(opts):
    jp, js, tp, ts = _run_both(opts)
    jflat, tflat = _host(jp), flatten_dict(tp)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_allclose(tflat[k].numpy(), jflat[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    jstate = jflatten(jax.tree_util.tree_map(np.asarray, js))
    tstate = flatten_dict(ts)
    assert jstate.keys() == tstate.keys()
    for k, jv in jstate.items():
        tv = tstate[k]
        if isinstance(jv, np.ndarray):
            assert tuple(tv.shape) == jv.shape, k
            assert str(tv.dtype).split(".")[-1] == str(jv.dtype), k
            # 1e-5 relative to the leaf's scale: an EMA entry near 0 is a
            # difference of two nearby terms
            np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5,
                                       atol=1e-5 * np.abs(jv).max(), err_msg=k)
        else:
            assert tv == jv, k  # the empty states of the stateless links


def test_adafactor_state_layout_is_jax_s():
    """count, v_row, v_col and v under the JAX names and shapes, with the
    (1,) placeholders: the [256, 2048] embedding factored, [64, 96] not."""
    np_params = _tree(0)
    js = j_adafactor(lambda c: 1e-2).init(jax.tree_util.tree_map(jnp.asarray, np_params))
    ts = t_adafactor(lambda c: torch.tensor(1e-2)).init(params_from_jax(np_params, "cpu"))
    shapes = {k: tuple(v.shape) for k, v in flatten_dict(ts).items()
              if isinstance(v, torch.Tensor)}
    assert shapes == {k: tuple(np.shape(v)) for k, v in jflatten(js).items()
                      if hasattr(v, "shape")}
    assert shapes["1.v_row.tok_embeddings.weight"] == (256,)
    assert shapes["1.v_col.tok_embeddings.weight"] == (2048,)
    assert shapes["1.v.tok_embeddings.weight"] == (1,)
    assert shapes["1.v.layers.0.feed_forward.w_up.weight"] == (64, 96)
    assert shapes["1.v_row.layers.0.feed_forward.w_up.weight"] == (1,)
    assert shapes["1.count"] == () and shapes["3.count"] == ()
    for shape in ((2048, 160), (160, 2048), (64, 96), (2048,), (3, 200, 300)):
        assert t_factored(shape, 128) == j_factored(shape, 128)


def test_jax_adafactor_state_carries_into_the_port():
    """convert.opt_state_from_jax: a JAX state after 5 steps continues in
    the port for a sixth step exactly as in JAX."""
    opts = OPTIONS[0]
    jp, js, _, _ = _run_both(opts)
    grads = _tree(200)
    sched = dict(peak=1e-2, total_steps=10, warmup_steps=2, end_value=1e-3)
    jopt = j_adafactor(jsched.warmup_cosine(**sched), **opts)
    topt = tbase.in_place(t_adafactor(tsched.warmup_cosine(**sched), **opts))
    u, js6 = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
    jp6 = jbase.apply_updates(jp, u)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tp6, ts6 = topt.fused_apply(params_from_jax(grads, "cpu"), ts, tp)
    jflat, tflat = _host(jp6), flatten_dict(tp6)
    for k in jflat:
        np.testing.assert_allclose(tflat[k].numpy(), jflat[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert int(flatten_dict(ts6)["1.count"]) == int(js6[1]["count"]) == 6


class _Cfg:
    def __init__(self, optimization, **hp):
        self.optimization = optimization
        self.hyperparameters = hp
        self.optimizer_name = optimization["optimizer"]
        self.weight_decay = hp.get("weight_decay", 0.0)
        self.gradient_clip = hp.get("gradient_clip")
        self.learning_rate = hp.get("learning_rate", 1e-2)
        self.scheduler = {}


def test_factory_builds_adafactor_as_jax_does():
    cfg = _Cfg({"optimizer": "adafactor", "clipping_threshold": 1.0, "momentum": 0.5,
                "decay_rate": 0.7, "multiply_by_parameter_scale": False},
               weight_decay=0.01, gradient_clip=0.5)
    np_params = _tree(0)
    jopt = jfactory.build_optimizer(cfg, 10)
    topt = tfactory.build_optimizer(cfg, 10)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(2):
        grads = _tree(50 + step)
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        jp = jbase.apply_updates(jp, u)
        tp, ts = topt.fused_apply(params_from_jax(grads, "cpu"), ts, tp)
    jflat, tflat = _host(jp), flatten_dict(tp)
    for k in jflat:
        np.testing.assert_allclose(tflat[k].numpy(), jflat[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert flatten_dict(ts).keys() == jflatten(jax.tree_util.tree_map(np.asarray, js)).keys()
    # every JAX name builds now (tests/test_torch_optimizers.py); an unknown
    # one raises as in JAX
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        tfactory.build_optimizer(_Cfg({"optimizer": "lamb"}), 10)
