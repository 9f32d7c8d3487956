"""Remat policies, ``scan_layers`` and the fused CE of the port's model, on
the CPU.

Each remat policy, at ratios 0.5 and 1.0, and ``scan_layers`` give the
no-remat loss and gradients (the same arithmetic, recomputed); the
policies checkpoint the layers JAX wraps (``round(num_layers * ratio)``
of them, 8 of 16 at the default ratio) and keep what JAX's keep; the
fused CE matches the plain CE and the JAX ``fused_cross_entropy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.ops import fused_ce as jfce
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.ops import fused_ce as tfce
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import leaves_with_path

SEQ = 64


def _args(num_layers=4, **kw):
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=num_layers, num_heads=4, num_kv_heads=2, head_dim=16,
                attention_type="flash")
    base.update(kw)
    return jl.LlamaArgs(**base), tl.LlamaArgs(**base)


def _np_params(jargs, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jargs))

    def leaf(x):
        if len(x.shape) == 1:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (1.5 * x.shape[-2] ** -0.5 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


def _batch(seed=1, b=2, vocab=256):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, size=(b, SEQ + 1)).astype(np.int32)
    mask = np.ones((b, SEQ), np.float32)
    mask[0, SEQ // 2:] = 0.0
    return {"inputs": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


def _loss_grads(tp, targs, batch, **kw):
    for _, p in leaves_with_path(tp):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = tl.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                         targs, **kw)
    loss.backward()
    return loss.item(), {"/".join(k): p.grad.clone() for k, p in leaves_with_path(tp)}


@pytest.fixture(scope="module")
def model():
    jargs, targs = _args()
    return jargs, targs, _np_params(jargs), _batch()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("remat", ["full", "dots", "save_attn"])
def test_remat_policy_gives_the_no_remat_loss_and_gradients(model, remat, ratio, dtype):
    _, targs, np_params, batch = model
    tp = params_from_jax(np_params, "cpu")
    dt = getattr(torch, dtype)
    l0, g0 = _loss_grads(tp, targs, batch, compute_dtype=dt, z_loss_weight=1e-4)
    l1, g1 = _loss_grads(tp, targs, batch, compute_dtype=dt, z_loss_weight=1e-4,
                         remat=remat, remat_ratio=ratio)
    assert l1 == l0  # the same operations, run again: bitwise
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("remat", [None, "full"])
def test_scan_layers_changes_no_number_and_matches_jax(model, remat):
    """scan_layers runs the same loop in the same remat segments: bitwise
    the loss and gradients without it, and JAX's scanned loss within 1e-5."""
    jargs, targs, np_params, batch = model
    tp = params_from_jax(np_params, "cpu")
    l0, g0 = _loss_grads(tp, targs, batch, remat=remat, remat_ratio=0.5)
    l1, g1 = _loss_grads(tp, targs, batch, remat=remat, remat_ratio=0.5, scan_layers=True)
    assert l1 == l0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    j_loss, _ = jl.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jargs,
                           remat=remat, remat_ratio=0.5, scan_layers=True)
    np.testing.assert_allclose(l1, float(j_loss), rtol=1e-5)


def _count_wrapped(monkeypatch, targs, tp, batch, **kw):
    calls = []
    real = tl.checkpoint

    def counting(fn, *args, **ckw):
        calls.append(ckw.get("context_fn"))
        return real(fn, *args, **ckw)

    monkeypatch.setattr(tl, "checkpoint", counting)
    _loss_grads(tp, targs, batch, **kw)
    return calls


def test_default_ratio_wraps_8_of_16_layers_as_jax(monkeypatch):
    """system.gradient_checkpointing_ratio defaults to 0.5 (as in JAX), and
    remat: full then checkpoints round(16 * 0.5) = 8 layers."""
    jargs, targs = _args(num_layers=16, hidden_size=32, intermediate_size=64,
                         num_heads=2, num_kv_heads=2)
    tp = params_from_jax(_np_params(jargs), "cpu")
    ratio = TConfig.from_dict({"name": "x"}).system.gradient_checkpointing_ratio
    assert ratio == 0.5
    calls = _count_wrapped(monkeypatch, targs, tp, _batch(b=1), remat="full",
                           remat_ratio=ratio)
    assert len(calls) == 8 == int(round(jargs.num_layers * ratio))
    assert _count_wrapped(monkeypatch, targs, tp, _batch(b=1), remat=None) == []


@pytest.mark.parametrize("remat,saved", [
    ("full", {}),
    ("dots", {"mm": 7}),  # wq, wk, wv, wo, w_gate, w_up, w_down; no bmm
    ("save_attn", {"alias": 4}),  # the tagged qkv (3) and attn_out
])
def test_policy_keeps_what_jax_keeps(model, remat, saved):
    """The ops a policy's selective checkpoint saves run, per layer, at
    exactly the sites JAX's policy keeps: every projection for "dots"
    (attention's batched products are other ops), the four tags for
    "save_attn"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, targs, np_params, batch = model
    tp = params_from_jax(np_params, "cpu")
    ops = tl._SAVED_OPS.get(remat, [])
    seen = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops:
                name = func.overloadpacket.__name__
                seen[name] = seen.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():  # the layers only: the output projection is another matmul
        tl.forward(tp, torch.from_numpy(batch["inputs"]), targs, remat=remat,
                   remat_ratio=0.25, return_hidden=True)  # one wrapped layer
    assert seen == {k: n * targs.num_layers for k, n in saved.items()}


@pytest.mark.parametrize("remat,ratio,calls", [(None, 0.5, 4), ("full", 0.5, 6),
                                               ("full", 1.0, 8), ("save_attn", 1.0, 8)])
def test_remat_reruns_the_flash_forward_in_the_backward(model, monkeypatch, remat, ratio,
                                                        calls):
    """A remat'd layer's flash forward runs again in the backward (4 layers:
    4 calls without remat, one more per wrapped layer), and the backward
    kernels read the O and lse of that run: the gradients stay exact."""
    from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as fa

    _, targs, np_params, batch = model
    tp = params_from_jax(np_params, "cpu")
    _, g0 = _loss_grads(tp, targs, batch)
    seen = []
    real = fa.flash_fwd

    def counting(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_fwd", counting)
    _, g1 = _loss_grads(tp, targs, batch, remat=remat, remat_ratio=ratio)
    assert len(seen) == calls
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


def test_unknown_remat_policy_raises_as_in_jax():
    with pytest.raises(ValueError) as jerr:
        jl.normalize_remat("ful")
    with pytest.raises(ValueError) as terr:
        tl.normalize_remat("ful")
    assert str(terr.value) == str(jerr.value)
    assert tl.normalize_remat("None") is None and tl.normalize_remat("") is None


# -- the fused CE ---------------------------------------------------------------------

@pytest.mark.parametrize("with_z", [False, True])
@pytest.mark.parametrize("chunk", [48, 2048])
def test_fused_ce_matches_jax_and_the_plain_ce(chunk, with_z):
    rng = np.random.default_rng(3)
    N, D, V = 128, 64, 256
    hidden = (rng.standard_normal((2, N // 2, D))).astype(np.float32)
    w = (0.2 * rng.standard_normal((V, D))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(V)).astype(np.float32)
    t = rng.integers(0, V, size=(2, N // 2)).astype(np.int32)
    m = (rng.random((2, N // 2)) > 0.2).astype(np.float32)

    def j_fn(h, w, b):
        out = jfce.fused_cross_entropy(h, w, jnp.asarray(t), jnp.asarray(m), bias_v=b,
                                       logit_scale=0.5, chunk=chunk, with_z=with_z)
        return out[0] + 0.1 * out[1] if with_z else out

    j_val, j_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(bias))
    th, tw, tb = (torch.from_numpy(x).requires_grad_(True) for x in (hidden, w, bias))
    out = tfce.fused_cross_entropy(th, tw, torch.from_numpy(t), torch.from_numpy(m),
                                   bias_v=tb, logit_scale=0.5, chunk=chunk, with_z=with_z)
    t_val = out[0] + 0.1 * out[1] if with_z else out
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-5)
    for g, jg in zip((th.grad, tw.grad, tb.grad), j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(jg)).max())

    # the plain CE on full logits, through torch autograd
    ph, pw, pb = (torch.from_numpy(x).requires_grad_(True) for x in (hidden, w, bias))
    logits = ((ph.reshape(N, D) @ pw.t()) + pb) * 0.5
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, torch.from_numpy(t).reshape(N, 1).long())[:, 0]
    mm = torch.from_numpy(m).reshape(N)
    p_val = ((logz - gold) * mm).sum()
    if with_z:
        p_val = p_val + 0.1 * (logz.square() * mm).sum()
    p_val.backward()
    np.testing.assert_allclose(t_val.item(), p_val.item(), rtol=1e-5)
    for g, pg in ((th.grad, ph.grad), (tw.grad, pw.grad), (tb.grad, pb.grad)):
        np.testing.assert_allclose(g.numpy(), pg.numpy(), rtol=1e-5,
                                   atol=1e-5 * pg.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_with_fused_ce_matches_plain_and_jax(model, dtype):
    """ce_chunk > 0 folds the projection into the loss: the plain path's
    loss and gradients (fp32 both; bf16 alike, sums in another order), and
    JAX's fused loss, with the z-loss on."""
    jargs, targs, np_params, batch = model
    tp = params_from_jax(np_params, "cpu")
    dt = getattr(torch, dtype)
    l0, g0 = _loss_grads(tp, targs, batch, compute_dtype=dt, ce_chunk=0,
                         z_loss_weight=1e-3)
    l1, g1 = _loss_grads(tp, targs, batch, compute_dtype=dt, ce_chunk=48,
                         z_loss_weight=1e-3)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for k in g0:
        scale = g0[k].abs().max().item()
        tol = 1e-5 if dtype == "float32" else 2 ** -8  # one bf16 rounding of dW
        torch.testing.assert_close(g1[k], g0[k], rtol=tol, atol=tol * scale, msg=k)
    j_loss, _ = jl.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_params),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jargs,
                           compute_dtype=getattr(jnp, dtype), ce_chunk=48,
                           z_loss_weight=1e-3)
    np.testing.assert_allclose(l1, float(j_loss), rtol=1e-5 if dtype == "float32" else 1e-4)


def test_auto_chunk_is_jax_s():
    for shape in ((8, 2048, 259), (16, 2048, 32768), (4, 4096, 65536), (1, 1, 1)):
        assert tfce.auto_chunk(*shape) == jfce.auto_chunk(*shape)
