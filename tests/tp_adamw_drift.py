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

    env PYTHONPATH=. JAX_PLATFORMS=cpu python tests/tp_adamw_drift.py OUT_DIR
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (8 virtual CPU devices, before JAX starts)
import numpy as np  # noqa: E402
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


def ratios(ref, other, tol=1e-5):
    """{leaf: |other - ref| / (tol x max|ref|)} over ref's float leaves."""
    out = {}
    for k, j in ref.items():
        if isinstance(j, np.ndarray) and j.dtype.kind == "f":
            j = j.astype(np.float32)
            out[k] = np.abs(np.asarray(other[k], np.float32) - j) / (
                tol * max(float(np.abs(j).max()), 1e-30))
    return out


def main(out):
    os.makedirs(out, exist_ok=True)
    write_inputs(out, {"tp_models": T.MODELS, "tp": CASES})
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
        print(f"== {c['name']} (AdamW)")
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
    main(sys.argv[1])
