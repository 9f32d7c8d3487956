"""Why three tp training cases of ``tests/test_torch_tp_train.py`` run
momentum SGD and not AdamW: under AdamW, JAX against itself breaks the same
leaf limit.

For each case it trains 5 AdamW steps (``tests/test_torch_dist_train.py``'s
``TRAINING``) three ways: the port on 4 gloo ranks with the case's mesh
(the worker's ``tp`` task), JAX on the same mesh over 4 virtual CPU
devices, and JAX on one device. It prints, for the losses and
``grad_norm``, the largest relative difference of the port from JAX's mesh
run and of JAX's one-device run from it; then, for the leaves the port
misses most, each one's worst element against the tests' limit (1e-5 of
the JAX leaf's largest entry) beside JAX's one-device run's, and the
second moment (``nu``) at the port's worst elements.

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/tp_adamw_drift.py OUT_DIR [--float64]

``--float64`` runs all three in float64: the weights, the inputs and the
optimizer state, with ``jax_enable_x64`` in this process only and the
port's ranks told so through ``spec.json`` (``tests/torch_dist_worker.py``
``float64_everywhere``). Both packages pin fp32 at the same places (RMSNorm,
RoPE, the logits, the router, AdamW's moments and update: port
``models/llama.py:258``, ``:346``, ``:791``, ``models/moe.py:270``,
``optim/fused.py:41``, ``:70``, ``:83``; JAX's ``astype(jnp.float32)`` at
the same sites); in this mode those pins name float64 in both processes
(``jnp.float32`` and ``torch.float32`` rebound, ``Tensor.float`` made
``double``), so no step of either side rounds to fp32.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (8 virtual CPU devices, before JAX starts)
import numpy as np  # noqa: E402

FLOAT64 = "--float64" in sys.argv
if FLOAT64:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64  # the JAX package's fp32 pins, float64 here
import test_torch_tp_train as T  # noqa: E402
from test_torch_dist_train import launch_worker, wait_ok, write_inputs  # noqa: E402

from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten  # noqa: E402

CASES = [  # the three cases of the test under AdamW, and tp4 (AdamW there too)
    dict(name="dp2tp2_z1_dense_fused_z_dots", mesh=T.DP2TP2, zero=1, model="dense", ce=16,
         z=T.Z, remat="dots"),
    dict(name="fsdp2tp2_z0_dense_z", mesh=T.FSDP2TP2, zero=0, model="dense", ce=0, z=T.Z),
    dict(name="fsdp2tp2_z1_gqa_fused_dots", mesh=T.FSDP2TP2, zero=1, model="gqa", ce=16,
         remat="dots"),
    dict(name="tp4_z0_dense", mesh=T.TP4, zero=0, model="dense", ce=0),
]


DTYPE = np.float64 if FLOAT64 else np.float32
if FLOAT64:
    _jax_params, _batches = T.jax_params, T.batches
    T.jax_params = lambda *a: __import__("jax").tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), _jax_params(*a))
    T.batches = lambda *a: [dict(b, mask=b["mask"].astype(np.float64)) for b in _batches(*a)]


def ratios(ref, other, tol=1e-5):
    """{leaf: |other - ref| / (tol x max|ref|)} over ref's float leaves."""
    out = {}
    for k, j in ref.items():
        if isinstance(j, np.ndarray) and j.dtype.kind == "f":
            j = j.astype(DTYPE)
            out[k] = np.abs(np.asarray(other[k], DTYPE) - j) / (
                tol * max(float(np.abs(j).max()), 1e-30))
    return out


def main(out):
    os.makedirs(out, exist_ok=True)
    write_inputs(out, {"tp_models": T.MODELS, "tp": CASES, "float64": FLOAT64})
    np.savez(os.path.join(out, "batches.npz"),
             **{f"{k}_{i}": v for i, b in enumerate(T.batches()) for k, v in b.items()})
    for name, model in T.MODELS.items():
        np.savez(os.path.join(out, f"tp_{name}.npz"), **jflatten(T.jax_params(1, model)))
    wait_ok(launch_worker(4, "tp", out), os.path.join(out, "tp_4.log"))
    for c in CASES:
        js, jm = T.jax_run(c)
        j1, jm1 = T.jax_run(dict(c, mesh={"dp": 1}, zero=0))
        js, j1 = T.numpy_tree(js), T.numpy_tree(j1)
        got = np.load(os.path.join(out, f"tp_{c['name']}.npz"))
        print(f"== {c['name']} (AdamW, {'float64' if FLOAT64 else 'fp32'})")
        for i, what in ((0, "loss"), (1, "grad_norm")):
            print(f"  {what}: port {np.abs(got['metrics'][:, i] / jm[:, i] - 1).max():.3g}, "
                  f"JAX one device {np.abs(jm1[:, i] / jm[:, i] - 1).max():.3g} (relative)")
        nu = {k: v for k, v in jflatten(js["opt_state"]).items() if ".nu." in f".{k}."}
        for pre, key in (("p.", "params"), ("o.", "opt_state")):
            ref = jflatten(js[key])
            port = ratios(ref, {k[2:]: got[k] for k in got.files if k.startswith(pre)})
            own = ratios(ref, jflatten(j1[key]))
            for k in sorted(port, key=lambda k: -port[k].max())[:3]:
                r = port[k]
                line = (f"  {pre}{k}: port {r.max():.3g}x the limit ({int((r > 1).sum())} of "
                        f"{r.size} past it); JAX one device {own[k].max():.3g}x "
                        f"({int((own[k] > 1).sum())} past it)")
                at = [n for n in nu if n.endswith(k)]
                if pre == "p." and at:
                    worst = np.unravel_index(int(np.argmax(r)), r.shape)
                    line += (f"; nu at the port's worst {float(np.asarray(nu[at[0]])[worst]):.3g}"
                             f", median {float(np.median(np.asarray(nu[at[0]]))):.3g}")
                print(line)


if __name__ == "__main__":
    main([a for a in sys.argv[1:] if not a.startswith("--")][0])
