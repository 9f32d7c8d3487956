"""The port's optimizer factory against the JAX package's, on the CPU.

Every name the JAX factory builds (besides Adafactor, in
``test_torch_adafactor.py``): five updates of each on the same parameters
and gradients (numpy from a seed; the gradients large enough that the
global-norm clip acts), then the parameters and every state leaf under the
JAX flattened names within 1e-5 relative, 1e-4 where Shampoo's inverse
roots enter: ``eigh`` differs in its last bits between LAPACK builds, and
the roots raise eigenvalues to the -1/4 power. A leaf whose statistics at a
refresh have an eigenvalue just above the clamp (under 100x ``eps`` times
the largest, in float64 from JAX's own statistics) is held at 5e-3: there
fp32 ``eigh``'s absolute error, ~1e-7 of the largest eigenvalue, is a
relative error of several percent on the smallest ones that the root keeps
(measured: 3.6e-3 on such a root, 1e-6 on the others).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.optim import base as jbase
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch import convert
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.optim import base as tbase
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict

# the packages' __init__ export functions named like these modules
jshampoo = importlib.import_module("mlx_cuda_distributed_pretraining_tpu.optim.shampoo")
tshampoo = importlib.import_module("mlx_cuda_distributed_pretraining_tpu_torch.optim.shampoo")


class Cfg:
    """The training-section fields both factories read."""

    def __init__(self, optimization, weight_decay=0.01, gradient_clip=1.0,
                 learning_rate=1e-2):
        self.optimization = optimization
        self.optimizer_name = optimization["optimizer"]
        self.weight_decay = weight_decay
        self.gradient_clip = gradient_clip
        self.learning_rate = learning_rate
        self.hyperparameters = {"learning_rate": learning_rate}
        self.scheduler = {"type": "cosine_with_warmup", "warmup_steps": 2,
                          "min_lr_ratio": 0.1}


def tree(seed, scale=0.05):
    """Llama-shaped: a [64, 32] embedding, square, wide and tall
    projections, a [3, 32, 48] stacked bank, norm gains and a bias."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "tok_embeddings": {"weight": n(64, 32)},
        "layers": [{"attention": {"wq": {"weight": n(32, 32)},
                                  "wk": {"weight": n(32, 16), "bias": n(16)}},
                    "attention_norm": {"weight": 1.0 + n(32)},
                    "feed_forward": {"w_gate": {"weight": n(32, 48)},
                                     "w_down": {"weight": n(48, 32)},
                                     "experts": {"w_up": {"weight": n(3, 32, 48)}}}}
                   for _ in range(2)],
        "norm": {"weight": 1.0 + n(32)},
    }


SHAMPOO = {"update_period": 2, "start_preconditioning_step": 2,
           "max_preconditioner_dim": 40}
CASES = {
    "sgd": ({"optimizer": "sgd", "momentum": 0.9}, 1e-5),
    "sgd_enhanced": ({"optimizer": "sgd_enhanced", "ema_decay": 0.9}, 1e-5),
    "lion": ({"optimizer": "lion"}, 1e-5),
    "lion_enhanced": ({"optimizer": "lion_enhanced", "betas": [0.8, 0.95],
                       "ema_decay": 0.9}, 1e-5),
    "adamw_enhanced": ({"optimizer": "adamw_enhanced", "betas": [0.9, 0.95],
                        "ema_decay": 0.9}, 1e-5),
    "adam_unfused": ({"optimizer": "adam", "fused": False}, 1e-5),
    "adamw_unfused": ({"optimizer": "adamw", "fused": False, "amsgrad": True}, 1e-5),
    "adamw_fused": ({"optimizer": "adamw", "betas": [0.9, 0.95]}, 1e-5),
    "muon": ({"optimizer": "muon", "adamw_lr_ratio": 0.04}, 1e-5),
    "shampoo": (dict(SHAMPOO, optimizer="shampoo"), 1e-4),
    "hybrid_matrix": ({"optimizer": "hybrid", "matrix_optimizer": "muon",
                       "non_matrix_optimizer": "adamw", "adamw_lr_ratio": 0.04}, 1e-5),
    "hybrid_rest": (dict(SHAMPOO, optimizer="hybrid", matrix_optimizer="shampoo",
                         non_matrix_optimizer="lion", hybrid_embeddings="rest"), 1e-4),
}


def _host(t):
    return jflatten(jax.tree_util.tree_map(np.asarray, t))


def ill_conditioned(jstate, eps=1e-6, margin=100.0):
    """Names of the leaves whose Shampoo statistics (in a JAX state, at a
    refresh) have an eigenvalue in ``(eps, margin * eps]`` of the largest."""
    out = set()
    for key, v in _host(jstate).items():
        if key.endswith((".stats_l", ".stats_r")) and np.ndim(v) >= 2 \
                and np.shape(v)[-1] == np.shape(v)[-2]:
            lam = np.linalg.eigvalsh(np.asarray(v, np.float64))
            rel = lam / lam.max(axis=-1, keepdims=True)
            if ((rel > eps) & (rel <= margin * eps)).any():
                out.add(key.rsplit(".", 2)[0].split("per_param.", 1)[-1])
    return out


def run_both(optimization, steps=5, refreshes=(), flagged=None):
    cfg = Cfg(optimization)
    jopt = jfactory.build_optimizer(cfg, 20)
    topt = tfactory.build_optimizer(cfg, 20)
    np_params = tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        grads = tree(100 + step, scale=1.0)  # global norm ~ 30: the clip acts
        u, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        jp = jbase.apply_updates(jp, u)
        tp, ts = topt.fused_apply(params_from_jax(grads, "cpu"), ts, tp)
        if flagged is not None and step + 1 in refreshes:
            flagged |= ill_conditioned(js)
    return jp, js, tp, ts


def assert_trees_close(jtree, ttree, tol, loose=frozenset(), loose_tol=5e-3):
    jflat, tflat = _host(jtree), flatten_dict(ttree)
    assert tflat.keys() == jflat.keys()
    for key, jv in jflat.items():
        tv = tflat[key]
        if isinstance(tv, torch.Tensor):
            jv = np.asarray(jv)
            assert tuple(tv.shape) == jv.shape, key
            t = loose_tol if any(name in key for name in loose) else tol
            np.testing.assert_allclose(tv.float().numpy(), jv.astype(np.float32), rtol=t,
                                       atol=t * max(float(np.abs(jv).max()), 1e-30),
                                       err_msg=key)
        else:
            assert tv == jv, key  # the empty states of the stateless links, None leaves


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax_over_five_updates(case):
    optimization, tol = CASES[case]
    flagged = set()
    jp, js, tp, ts = run_both(optimization, refreshes=(2, 4), flagged=flagged)
    assert len(flagged) <= 2, flagged  # the loose tolerance stays an exception
    assert_trees_close(jp, tp, tol, flagged)
    assert_trees_close(js, ts, tol, flagged)


def test_unknown_names_raise_as_in_jax():
    for name in ("adagrad", "hybrid"):
        opt = {"optimizer": name, "hybrid_embeddings": "vocab"}
        with pytest.raises(ValueError) as jerr:
            jfactory.build_optimizer(Cfg(opt), 10)
        with pytest.raises(ValueError) as terr:
            tfactory.build_optimizer(Cfg(opt), 10)
        assert str(terr.value) == str(jerr.value)


def test_hybrid_clips_each_branch_by_its_own_norm():
    """In a partition, the clip inside each branch sees only that branch's
    leaves: with the vectors' gradients huge and the matrices' tiny, the
    matrix branch is not scaled down by the vectors' norm."""
    cfg = Cfg({"optimizer": "hybrid", "matrix_optimizer": "sgd",
               "non_matrix_optimizer": "sgd", "momentum": 0.0}, weight_decay=0.0)
    topt = tfactory.build_transform(cfg, 10)
    params = params_from_jax(tree(0), "cpu")
    grads = tbase.map_with_path(
        lambda path, p: torch.full_like(p, 1e-3 if p.dim() >= 2 and not
                                        tbase.is_vector_like_path(path) else 1e3), params)
    u, _ = topt.update(grads, topt.init(params), params)
    lr = float(tfactory.build_schedule(cfg, 10)(1))
    wq = u["layers"][0]["attention"]["wq"]["weight"]
    torch.testing.assert_close(wq, torch.full_like(wq, -1e-3 * lr))


@pytest.mark.parametrize("shape", [(6, 6), (3, 40, 40)])
def test_inverse_pth_root_matches_jax(shape):
    rng = np.random.default_rng(1)
    g = rng.standard_normal(shape[:-1] + (9,)).astype(np.float32)
    mat = g @ np.swapaxes(g, -1, -2)  # PSD; rank 9 < 40 takes the clamp
    t = tshampoo.inverse_pth_root(torch.from_numpy(mat), 4).numpy()
    if len(shape) == 2:
        j = np.asarray(jshampoo.inverse_pth_root(jnp.asarray(mat), 4))
    else:
        j = np.asarray(jax.vmap(lambda m: jshampoo.inverse_pth_root(m, 4))(jnp.asarray(mat)))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


@pytest.mark.parametrize("case", ["muon", "shampoo", "lion_enhanced", "hybrid_rest"])
def test_states_cross_packages_both_ways(case):
    """``convert.opt_state_from_jax`` carries a JAX state after 5 updates
    into the port, whose 6th update is JAX's 6th; ``opt_state_to_jax``
    carries the port's state back leaf for leaf."""
    optimization, tol = CASES[case]
    jp, js, _, _ = run_both(optimization)
    cfg = Cfg(optimization)
    jopt, topt = jfactory.build_optimizer(cfg, 20), tfactory.build_optimizer(cfg, 20)
    ts = convert.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    back = convert.opt_state_to_jax(ts)
    assert jflatten(back).keys() == _host(js).keys()
    for key, v in _host(js).items():
        b = jflatten(back)[key]
        assert (b is None and v is None) or np.array_equal(np.asarray(b), np.asarray(v)), key
    grads = tree(300, scale=1.0)
    u, js6 = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
    jp6 = jbase.apply_updates(jp, u)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    tp6, ts6 = topt.fused_apply(params_from_jax(grads, "cpu"), ts, tp)
    assert_trees_close(jp6, tp6, tol)
    assert_trees_close(js6, ts6, tol)
