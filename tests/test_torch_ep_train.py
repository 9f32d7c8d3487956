"""The port's expert-parallel training over torch.distributed against the JAX
package's on the same mesh, on the CPU.

The port side runs gloo ranks started through the port's launcher
(``tests/torch_dist_worker.py``, tasks ``ep``, ``epfwd``, ``epckpt``,
``epresume``): one world of 4 ranks for the ep meshes, one of 2 for
``{dp: 2, ep: 1}`` and one of 1 for a resume. The JAX side runs in the test
process on the first 4 (or 2) of the 8 virtual CPU devices, its step traced
under ``use_mesh(mesh)`` as JAX's trainer sets it (without it JAX's
``moe_block`` sees no mesh and takes the local path). Weights are JAX's,
inputs numpy from a seed. The JAX grouped GEMM runs its CPU backend
(``blocked``); the port its kernels' plain versions.

- 5 steps at {ep: 4}, {dp: 2, ep: 2} with ZeRO 0 and 1, and {ep: 2, fsdp:
  2} with ZeRO-1 and remat ``dots`` (moe-1b's shape of mesh), dropless;
  {dp: 2, ep: 2} at ``moe_ep_capacity_factor`` 0.5 (drops); {ep: 4} under
  ``matmul_precision: int8`` (one step: past it the int8 grid turns the
  updates' reordered fp32 sums into flipped roundings), and {ep: 4} on
  the einsum impl (whole banks gathered over ep). Momentum SGD, as the MoE cases of
  ``tests/test_torch_dist_train.py``; and AdamW at {dp: 2, ep: 2} ZeRO-1
  at the leaf tolerance that ``tests/test_torch_tp_train.py``'s AdamW case
  states. Losses and ``grad_norm`` within 1e-5 relative, the global token
  count, drop count and expert loads equal, every param and optimizer leaf
  within 1e-5 of its largest entry.
- The MoE block forward, fp banks at factor 0.5 and an int8-quantized
  expert tree (dequantized whole for the exchange, as JAX's
  ``_maybe_dequant_experts`` does), against JAX's: outputs within 1e-5 of
  their largest entry, drop counts and aux losses equal.
- ``{dp: 2, ep: 1}`` at factor 0.5 (a mesh of 2 ranks that names ep, so JAX
  takes the ep dispatch): 64 of 128 selections dropped at B 4, S 16, D 32,
  E 4, K 2, as JAX drops them, and 3 training steps.
- A {dp: 2, ep: 2} ZeRO-1 checkpoint at step 3 resumes at {ep: 4} and at
  one rank, and JAX's step-3 files resume in the port: steps 4-5 against
  the uninterrupted run and JAX's.
- moe-1b's mesh ``{ep: 8, fsdp: -1}`` resolves as JAX's at 8 and 16 ranks.
"""

import json
import os

import jax
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.checkpoint.manager import CheckpointManager as JManager
from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.models import moe as jmoe
from mlx_cuda_distributed_pretraining_tpu.models import quantize as jq
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.parallel.context import use_mesh as j_use_mesh
from mlx_cuda_distributed_pretraining_tpu.parallel.mesh import mesh_axis_sizes as j_mesh_sizes
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch.parallel.mesh import mesh_axis_sizes
from mlx_cuda_distributed_pretraining_tpu_torch.utils.yaml_lite import safe_load as yaml_load
from test_torch_dist_train import (
    MOE_TRAINING,
    REPO,
    TRAINING,
    assert_leaves_close,
    global_batches,
    jax_mesh,
    jax_params,
    launch_worker,
    numpy_tree,
    shared_once,
    wait_ok,
    write_inputs,
)
from test_torch_tp_train import ADAMW_LEAF_TOL

E = 4
MODELS = {"moe": dict(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=8, max_position_embeddings=64,
                      tie_word_embeddings=False, num_local_experts=E,
                      num_experts_per_tok=2, router_z_weight=1e-3)}
EP4, DP2EP2, EP2FSDP2 = {"ep": 4}, {"dp": 2, "ep": 2}, {"fsdp": 2, "ep": 2}
CASES = [
    dict(name="ep4_z0", mesh=EP4, zero=0, model="moe"),
    dict(name="dp2ep2_z0", mesh=DP2EP2, zero=0, model="moe"),
    dict(name="dp2ep2_z1", mesh=DP2EP2, zero=1, model="moe"),
    dict(name="ep2fsdp2_z1_dots", mesh=EP2FSDP2, zero=1, model="moe", remat="dots"),
    dict(name="dp2ep2_z0_f05", mesh=DP2EP2, zero=0, model="moe", factor=0.5),
    # one step: the int8 grid is exact in fp32, but after the first update
    # the weights differ from JAX's by reordered fp32 sums, which flip
    # single int8 roundings (the loss then moves ~1e-5 relative at step 2)
    dict(name="ep4_z0_int8", mesh=EP4, zero=0, model="moe", precision="int8", steps=1),
    dict(name="dp2ep2_z1_adamw", mesh=DP2EP2, zero=1, model="moe", training=TRAINING),
    # the einsum impl: JAX runs it on the whole banks under GSPMD, the port
    # gathers them over ep (its gradient summed back into each rank's block)
    dict(name="ep4_z0_einsum", mesh=EP4, zero=0, model="moe", impl="einsum"),
]
for _c in CASES:
    _c.setdefault("training", MOE_TRAINING)
FWD_CASES = [dict(name="dp2ep2_f05", mesh=DP2EP2, model="moe", factor=0.5,
                  params="ep_fwd_fp.npz"),
             dict(name="ep4_int8_tree", mesh=EP4, model="moe", params="ep_fwd_q8.npz")]
# its run is also the checkpointed one: saved at step 3, resumed elsewhere
CKPT = next(c for c in CASES if c["name"] == "dp2ep2_z1")
# the 2-rank world: a mesh that names ep at 1 (JAX's ep dispatch all the same)
TWO = dict(name="dp2ep1_f05", mesh={"dp": 2, "ep": 1}, zero=0, model="moe", factor=0.5,
           training=MOE_TRAINING, steps=3)
TWO_FWD = dict(TWO, params="ep_fwd_fp.npz")


def case_args(case):
    return jl.LlamaArgs(**dict(MODELS[case["model"]],
                               moe_ep_capacity_factor=case.get("factor", 0.0),
                               matmul_precision=case.get("precision"),
                               moe_impl=case.get("impl", "grouped")))


def jax_run(case, steps=None, save_at=None):
    """JAX's train step on the case's mesh, traced under ``use_mesh``."""
    args = case_args(case)
    opt = jfactory.build_optimizer(
        JConfig.from_dict({"name": "j", "training": case["training"]}).training, 5)
    params = jax_params(1, MODELS[case["model"]])
    mesh = jax_mesh(case["mesh"])
    data = global_batches()
    metrics, routing = [], []
    with j_use_mesh(mesh):
        step, shardings = jts.make_train_step(
            lambda p, b: jl.loss_fn(p, b, args, ce_chunk=0, remat=case.get("remat"),
                                    with_moe_stats=True),
            opt, mesh=mesh, zero_level=case["zero"], log_grad_norm=True, params_like=params,
            moe_stats_experts=E)
        state = jax.device_put(jts.init_train_state(params, opt), shardings)
        for i in steps if steps is not None else range(case.get("steps", 5)):
            state, m = step(state, data[i])
            metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["toks"])))
            routing.append((float(m["moe_dropped"]), *np.asarray(m["moe_load"]).tolist()))
            if save_at is not None and i + 1 == save_at[0]:
                JManager(save_at[1]).save(i + 1, state["params"], state["opt_state"],
                                          {"step": i + 1})
    return numpy_tree(state), np.array(metrics), np.array(routing)


def fwd_inputs(out):
    """The MoE block's weights (fp, and the int8-quantized expert tree) and
    the probe's rows x [4, 16, 32]."""
    ff = jax_params(2, MODELS["moe"])["layers"][0]["feed_forward"]
    ff = jax.tree_util.tree_map(np.asarray, ff)
    q8 = dict(ff, experts={k: {n: np.asarray(v) for n, v in
                               jq.quantize_leaf(leaf["weight"], "int8").items()}
                           for k, leaf in ff["experts"].items()})
    x = np.random.default_rng(7).standard_normal((4, 16, 32)).astype(np.float32)
    for name, tree in (("ep_fwd_fp.npz", ff), ("ep_fwd_q8.npz", q8)):
        np.savez(os.path.join(out, name), **{"ff." + k: v for k, v in jflatten(tree).items()})
    np.savez(os.path.join(out, "ep_fwd_x.npz"), x=x)
    return {"ep_fwd_fp.npz": ff, "ep_fwd_q8.npz": q8}, x


def jax_fwd(case, trees, x):
    args = case_args(case)

    def f(p, x):
        with jmoe.routing_stats_tap() as tap:
            out, aux = jmoe.moe_block(p, x, args)
        return out, aux, tap[0]["moe_dropped"]

    with j_use_mesh(jax_mesh(case["mesh"])):
        out, aux, dropped = jax.jit(f)(trees[case["params"]], x)
    return np.asarray(out), float(aux), float(dropped)


def _inputs(out, extra):
    write_inputs(out, {"ep_models": MODELS, **extra})
    for name, model in MODELS.items():
        np.savez(os.path.join(out, f"ep_{name}.npz"), **jflatten(jax_params(1, model)))
    return fwd_inputs(out)


def _runs(out):
    two = os.path.join(out, "two")
    os.makedirs(two, exist_ok=True)
    trees, x = _inputs(out, {"ep": [c for c in CASES if c is not CKPT], "ep_fwd": FWD_CASES,
                             "ep_ckpt": CKPT, "ep_resume_mesh": EP4})
    _inputs(two, {"ep": [TWO], "ep_fwd": [TWO_FWD]})
    procs = {4: launch_worker(4, "epfwd,ep,epckpt,epresume", out),
             2: launch_worker(2, "epfwd,ep", two)}
    # JAX: its step-3 files first (the port's epckpt task reads them)
    ckpt_jax = os.path.join(out, "ep_ckpt_jax")
    ref = {"train": {CKPT["name"]: jax_run(CKPT, save_at=(3, ckpt_jax))}}
    with open(os.path.join(ckpt_jax, ".ready"), "w"):
        pass
    ref["train"].update({c["name"]: jax_run(c) for c in CASES + [TWO] if c is not CKPT})
    ref["ckpt"] = ref["train"][CKPT["name"]]
    ref["fwd"] = {c["name"]: jax_fwd(c, trees, x) for c in FWD_CASES + [TWO_FWD]}
    wait_ok(procs[2], os.path.join(two, "epfwd,ep_2.log"))
    wait_ok(procs[4], os.path.join(out, "epfwd,ep,epckpt,epresume_4.log"))
    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    spec["ep_resume_mesh"] = {}
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    wait_ok(launch_worker(1, "epresume", out), os.path.join(out, "epresume_1.log"))
    return out, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "ep_train", _runs)


def _result(out, name):
    if name == CKPT["name"]:  # the checkpointed run, uninterrupted
        name = "ckpt_uninterrupted"
    path = os.path.join(out, f"ep_{name}.npz")
    return np.load(path if os.path.exists(path)
                   else os.path.join(out, "two", f"ep_{name}.npz"))


def _check(got, jstate, jmetrics, jrouting, tol=1e-5):
    tm = got["metrics"]
    np.testing.assert_allclose(tm[:, 0], jmetrics[:, 0], rtol=1e-5)  # loss, aux in
    np.testing.assert_allclose(tm[:, 1], jmetrics[:, 1], rtol=1e-5)  # grad_norm
    np.testing.assert_array_equal(tm[:, 2], jmetrics[:, 2])  # global real tokens
    np.testing.assert_array_equal(got["routing"], jrouting)  # drops, expert loads
    assert_leaves_close(jstate["params"], got, "p.", tol)
    assert_leaves_close(jstate["opt_state"], got, "o.", tol)


@pytest.mark.parametrize("case", [c["name"] for c in CASES + [TWO]])
def test_ep_train_step_matches_jax(runs, case):
    out, ref = runs
    jstate, jmetrics, jrouting = ref["train"][case]
    tol = ADAMW_LEAF_TOL if case.endswith("adamw") else 1e-5
    _check(_result(out, case), jstate, jmetrics, jrouting, tol)
    if "f05" in case or "einsum" in case:
        assert (jrouting[:, 0] > 0).all()  # the cap acts at every step
    else:
        assert (jrouting[:, 0] == 0).all()


@pytest.mark.parametrize("case", [c["name"] for c in FWD_CASES + [TWO_FWD]])
def test_ep_moe_block_forward_matches_jax(runs, case):
    out, ref = runs
    jout, jaux, jdropped = ref["fwd"][case]
    path = os.path.join(out, f"ep_fwd_{case}.npz")
    got = np.load(path if os.path.exists(path)
                  else os.path.join(out, "two", f"ep_fwd_{case}.npz"))
    np.testing.assert_allclose(got["out"], jout, rtol=0,
                               atol=1e-5 * float(np.abs(jout).max()))
    assert float(got["dropped"]) == jdropped
    np.testing.assert_allclose(float(got["aux"]), jaux, rtol=1e-6)
    if case == "dp2ep1_f05":  # the probe: half of the 4 x 16 x 2 selections
        assert jdropped == 64.0


@pytest.mark.parametrize("where", ["uninterrupted", "resume_ep4", "resume_one", "from_jax"])
def test_ep_checkpoint_resumes_across_meshes(runs, where):
    out, ref = runs
    jstate, jmetrics, jrouting = ref["ckpt"]
    got = np.load(os.path.join(out, f"ep_{'ckpt_' if where == 'uninterrupted' else ''}"
                                    f"{where}.npz"))
    if where == "uninterrupted":
        _check(got, jstate, jmetrics, jrouting)
        return
    _check(got, jstate, jmetrics[3:], jrouting[3:])
    base = np.load(os.path.join(out, "ep_ckpt_uninterrupted.npz"))
    np.testing.assert_allclose(got["metrics"][:, 0], base["metrics"][3:, 0], rtol=1e-5)


@pytest.mark.parametrize("ranks", [8, 16])
def test_moe_1b_mesh_resolves_as_jax(ranks):
    with open(os.path.join(REPO, "configs", "model-config-moe-1b.yaml")) as f:
        mesh = yaml_load(f.read())["system"]["mesh"]
    cfg = type("System", (), {"mesh": mesh, "model_parallel": False})()
    got = mesh_axis_sizes(cfg, ranks)
    want = j_mesh_sizes(cfg, ranks)
    assert list(got.items()) == list(want.items())
    assert got == {"fsdp": ranks // 8, "ep": 8}
