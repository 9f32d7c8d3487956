"""The port's LR finder against the JAX package's, on the CPU.

``suggest_lr`` on fixed curves (identical); the momentum-SGD sweep and the
sweep with the configured optimizer on a tiny model, the smoothed losses
within 1e-5 relative (fp32, summation order only) and the suggestion
identical; the trainer adopting the suggestion on a fresh run and skipping
the sweep on resume, as the JAX trainer does.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.train import lr_finder as jlf
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.train import lr_finder as tlf
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer

from test_torch_train import _args, _batch, _config_dict, _random_params, _torch_batch

CURVES = [
    ([1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0], [5.0, 4.9, 4.0, 3.0, 3.5, 9.0]),
    ([1e-5, 1e-4, 1e-3, 1e-2, 1e-1], [5.0, 5.1, 5.2, 5.3, 5.4]),  # never falls
    ([1e-4, 1e-3, 1e-2], [4.0, 3.0, 2.0]),  # too short to take slopes
    ([], []),
    ([1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0],
     [3.0, 2.99, 2.9, 2.5, 2.45, 1.2, 1.1, float("nan")]),
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_suggest_lr_is_jaxs(curve):
    lrs, losses = CURVES[curve]
    assert tlf.suggest_lr(list(lrs), list(losses)) == jlf.suggest_lr(list(lrs), list(losses))


def _setup(tmp_path):
    d = _config_dict(tmp_path)
    jargs, targs = _args(d)
    np_params = _random_params(jargs, seed=4)
    batches = [_batch(20 + i) for i in range(8)]

    def j_loss(p, b):
        return jl.loss_fn(p, b, jargs, compute_dtype=jnp.float32)

    def t_loss(p, b):
        return tl.loss_fn(p, b, targs, compute_dtype=torch.float32)

    return d, np_params, batches, j_loss, t_loss


def test_momentum_sgd_sweep_matches_jax(tmp_path):
    d, np_params, batches, j_loss, t_loss = _setup(tmp_path)
    kw = dict(min_lr=1e-4, max_lr=3.0, num_steps=8)
    j_sugg, j_lrs, j_losses = jlf.run_lr_finder(
        jax.tree_util.tree_map(jnp.asarray, np_params), j_loss,
        lambda i: {k: jnp.asarray(v) for k, v in batches[i].items()},
        out_dir=str(tmp_path / "j"), **kw)
    tp = params_from_jax(np_params, "cpu")
    before = {k: v.clone() for k, v in tp["layers"][0]["attention"]["wq"].items()}
    t_sugg, t_lrs, t_losses = tlf.run_lr_finder(
        tp, t_loss, lambda i: _torch_batch(batches[i]), out_dir=str(tmp_path / "t"), **kw)
    assert t_lrs == j_lrs
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_sugg == j_sugg
    # the sweep ran on a copy: the caller's parameters are untouched
    torch.testing.assert_close(tp["layers"][0]["attention"]["wq"]["weight"], before["weight"],
                               rtol=0, atol=0)
    assert open(tmp_path / "t" / "lr_finder.csv").read().splitlines()[0] == \
        open(tmp_path / "j" / "lr_finder.csv").read().splitlines()[0]


def test_optimizer_sweep_matches_jax(tmp_path):
    d, np_params, batches, j_loss, t_loss = _setup(tmp_path)
    d["training"]["optimization"] = {"optimizer": "muon", "adamw_lr_ratio": 0.04}
    kw = dict(min_lr=1e-4, max_lr=1.0, num_steps=6)
    j_sugg, j_lrs, j_losses = jlf.run_lr_finder_for_optimizer(
        jax.tree_util.tree_map(jnp.asarray, np_params), j_loss,
        lambda i: {k: jnp.asarray(v) for k, v in batches[i].items()},
        JConfig.from_dict(d).training, "muon", **kw)
    t_sugg, t_lrs, t_losses = tlf.run_lr_finder_for_optimizer(
        params_from_jax(np_params, "cpu"), t_loss, lambda i: _torch_batch(batches[i]),
        TConfig.from_dict(d).training, "muon", **kw)
    np.testing.assert_allclose(t_lrs, j_lrs, rtol=1e-12)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_sugg == pytest.approx(j_sugg, rel=1e-12)


def _finder_config(tmp_path):
    d = _config_dict(tmp_path, iters=6)
    d["training"]["lr_finder"] = {"enabled": True, "num_steps": 6, "min_lr": 1e-4,
                                  "max_lr": 1.0}
    d["logging"]["steps"] = {"logging_interval": 1, "checkpoint_interval": 3,
                             "validation_interval": 0}
    return d


def test_trainer_adopts_the_suggestion_and_skips_it_on_resume(tmp_path):
    d = _finder_config(tmp_path)
    runs = str(tmp_path / "runs")
    tr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    init = {k: v.detach().clone() for k, v in tr.state["params"]["norm"].items()}
    # the sweep the trainer runs, on the same parameters and batches
    want, _, _ = tlf.run_lr_finder(
        tr.state["params"], tr.loss_fn,
        lambda i: tr._device_batch(tr.data.generate_batch(i)),
        min_lr=1e-4, max_lr=1.0, num_steps=6)
    assert tr.maybe_run_lr_finder() == want
    torch.testing.assert_close(tr.state["params"]["norm"]["weight"], init["weight"])
    assert tr.config.training.learning_rate == want
    assert int(tr.state["opt_state"][3]["count"]) == 0  # a fresh optimizer
    tr.state["step"] = 0
    tr.config.training._extras["lr_finder"]["enabled"] = False  # ran above
    result = tr.train()
    assert result["steps"] == 6
    log = open(os.path.join(tr.run_dir, "log.txt")).read()
    assert f"LR finder suggestion: {want:.3e}" in log
    assert os.path.isfile(os.path.join(tr.run_dir, "lr_finder.csv"))
    lr_1 = float(log.split("Step 1:")[1].split("lr=")[1].split(" |")[0])
    assert lr_1 == pytest.approx(float(tr.schedule(1)), rel=1e-3)  # the log prints 4 digits
    assert math.isclose(float(tr.schedule(0)), want, rel_tol=1e-6)  # cosine from the suggestion

    # resumed: the sweep is skipped, as in JAX
    d = _finder_config(tmp_path)
    d["training"]["hyperparameters"]["iters"] = 8
    d["resume"] = {"checkpoint": "6"}
    tr2 = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    assert tr2.start_step == 6
    assert tr2.maybe_run_lr_finder() is None
    assert tr2.train()["steps"] == 8
    log2 = open(os.path.join(tr2.run_dir, "log.txt")).read()
    assert log2.count("Running LR finder sweep") == 1
