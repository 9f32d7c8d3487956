"""The torch port's training path against the JAX package's, on the CPU.

Model, optimizer, schedules, data rows, the train step and the trainer. The
model runs ``use_flash_attention: true``: the port takes the flash kernels'
plain versions under its custom backward, the JAX side its Pallas kernels
in interpret mode. Weights and inputs are numpy from a seed, carried into
the port with ``convert.params_from_jax``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.data.memory import DataManager as JData
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.optim import fused as jfused
from mlx_cuda_distributed_pretraining_tpu.optim import schedules as jsched
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu.train import train_step as jts
from mlx_cuda_distributed_pretraining_tpu.train.trainer import (
    load_trained as j_load_trained,
)
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.data.memory import DataManager as TData
from mlx_cuda_distributed_pretraining_tpu_torch.models import llama as tl
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.optim import fused as tfused
from mlx_cuda_distributed_pretraining_tpu_torch.optim import schedules as tsched
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok
from mlx_cuda_distributed_pretraining_tpu_torch.train import train_step as tts
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import (
    load_trained as t_load_trained,
)

SEQ = 64


def _write_jsonl(path, texts):
    with open(path, "w") as f:
        for t in texts:
            f.write(json.dumps({"text": t}) + "\n")


def _config_dict(tmp_path, name="tiny", iters=30, flash=True):
    """``tests/test_trainer.py``'s tiny config, with flash attention."""
    train, val = tmp_path / "train.jsonl", tmp_path / "val.jsonl"
    corpus = ["the quick brown fox jumps over the lazy dog " * 4] * 40
    _write_jsonl(train, corpus)
    _write_jsonl(val, corpus[:10])
    return {
        "name": name,
        "overwrite": True,
        "data": {"input_file": str(train), "validation_file": str(val),
                 "preprocessing": {"max_context_size": SEQ},
                 "tokenizer": {"normal_vocab_size": 256}},
        "model": {
            "architecture": "llama",
            "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                           "num_layers": 2},
            "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                          "use_flash_attention": flash},
        },
        "training": {
            "hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                "iters": iters, "weight_decay": 0.05,
                                "gradient_clip": 1.0},
            "scheduler": {"type": "cosine", "min_lr_ratio": 0.1},
            "optimization": {"optimizer": "adamw", "betas": [0.9, 0.95]},
        },
        "logging": {"log_dir": "logs", "checkpoint_dir": "checkpoints",
                    "steps": {"logging_interval": 5, "checkpoint_interval": 15,
                              "validation_interval": 10}},
        "system": {"seed": 0, "device": "cpu"},
    }


def _args(d, vocab=259):
    return (jl.LlamaArgs.from_config(JConfig.from_dict(d).model, vocab),
            tl.LlamaArgs.from_config(TConfig.from_dict(d).model, vocab))


def _random_params(jargs, seed):
    """numpy weights at the JAX shapes: fan-in-scaled projections, small
    tied embeddings, norms near one."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if x.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        name = jax.tree_util.keystr(path)
        s = 0.05 if "tok_embeddings" in name else 1.5 * x.shape[-2] ** -0.5
        return (s * rng.standard_normal(x.shape)).astype(np.float32)

    shapes = jl.init_params(jax.random.PRNGKey(0), jargs)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(seed, b=4, s=SEQ):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 259, size=(b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0.0  # a padded tail
    return {"inputs": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat_grads(tree):
    return {jax.tree_util.keystr(p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_flat(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_torch_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


# fp32: summation order only. bf16 compute: both round to bf16 at nearly
# the same points, but not all (torch's silu rounds once, XLA's CPU
# compiler may round between sigmoid and product), and one bf16 ulp is
# 2**-8 relative. Logits and loss stay close; each side's gradients are
# ~5% (in norm) from the fp32 gradients, so the port's bf16 gradients are
# held to be nearer JAX's bf16 gradients than JAX's are to its own fp32 ones.
LOGITS_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _loss_and_grads(jargs, targs, np_params, batch, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")

    def j_loss(p):
        return jl.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          jargs, compute_dtype=jdt, z_loss_weight=1e-4)

    (j_val, j_toks), j_grads = jax.value_and_grad(j_loss, has_aux=True)(jp)
    for leaf in _torch_flat(tp).values():
        leaf.requires_grad_(True)
    t_val, t_toks = tl.loss_fn(tp, _torch_batch(batch), targs,
                               compute_dtype=tdt, z_loss_weight=1e-4)
    t_val.backward()
    assert float(t_toks) == float(j_toks)
    return ((float(j_val), _flat_grads(j_grads)),
            (float(t_val), {k: v.grad.numpy() for k, v in _torch_flat(tp).items()}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_jax(tmp_path, dtype):
    jargs, targs = _args(_config_dict(tmp_path))
    assert targs.attention_type == jargs.attention_type == "flash"
    np_params = _random_params(jargs, seed=1)
    batch = _batch(2)

    j_logits, _ = jl.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                             jnp.asarray(batch["inputs"]), jargs,
                             compute_dtype=getattr(jnp, dtype))
    t_logits, _ = tl.forward(params_from_jax(np_params, "cpu"),
                             torch.from_numpy(batch["inputs"]), targs,
                             compute_dtype=getattr(torch, dtype))
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **LOGITS_TOL[dtype])

    (j_val, jg), (t_val, tg) = _loss_and_grads(jargs, targs, np_params, batch, dtype)
    np.testing.assert_allclose(t_val, j_val, rtol=LOSS_RTOL[dtype])
    assert jg.keys() == tg.keys()
    if dtype == "float32":
        for name in jg:
            scale = np.abs(jg[name]).max()
            np.testing.assert_allclose(tg[name], jg[name], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)
        return
    (_, jg32), _ = _loss_and_grads(jargs, targs, np_params, batch, "float32")
    for name in jg:
        to_jax = np.linalg.norm(tg[name] - jg[name])
        jax_to_fp32 = np.linalg.norm(jg[name] - jg32[name])
        assert to_jax < 0.75 * jax_to_fp32, (name, to_jax, jax_to_fp32)


@pytest.mark.parametrize("mask_type,score_mod", [
    ("causal", None), ("sliding_window", "alibi"), ("prefix_lm", "soft_cap")])
def test_simple_attention_model_matches_jax(tmp_path, mask_type, score_mod):
    # The reference attention path, with the masks and the score mods the
    # flash path does not take (a flash config with a score mod runs it).
    d = _config_dict(tmp_path, flash=score_mod is not None)
    d["model"]["attention"].update(mask_type=mask_type, window_size=24,
                                   prefix_len=20, score_mod=score_mod,
                                   soft_cap=2.0)
    jargs, targs = _args(d)
    np_params = _random_params(jargs, seed=5)
    tokens = _batch(6)["inputs"]
    j_logits, _ = jl.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                             jnp.asarray(tokens), jargs)
    t_logits, _ = tl.forward(params_from_jax(np_params, "cpu"),
                             torch.from_numpy(tokens), targs)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-5, rtol=1e-5)


def test_flash_bf16_matmul_precision_matches_jax(tmp_path):
    # model.matmul_precision "bf16": q/k/v cast to bf16 for the flash
    # kernels under fp32 compute, the output promoted back for ``wo``.
    d = _config_dict(tmp_path)
    d["model"]["matmul_precision"] = "bf16"
    jargs, targs = _args(d)
    assert targs.matmul_precision == jargs.matmul_precision == "bf16"
    np_params = _random_params(jargs, seed=7)
    tokens = _batch(8)["inputs"]
    j_logits, _ = jl.forward(jax.tree_util.tree_map(jnp.asarray, np_params),
                             jnp.asarray(tokens), jargs)
    t_logits, _ = tl.forward(params_from_jax(np_params, "cpu"),
                             torch.from_numpy(tokens), targs)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **LOGITS_TOL["bfloat16"])


def test_weight_decay_mask_matches_jax(tmp_path):
    # Stacked [L, D] norm gains and biases stay undecayed by name.
    from mlx_cuda_distributed_pretraining_tpu.optim import base as jbase
    from mlx_cuda_distributed_pretraining_tpu_torch.optim import base as tbase

    d = _config_dict(tmp_path)
    d["model"]["misc"] = {"attention_bias": True, "mlp_bias": True,
                          "tie_word_embeddings": False}
    jargs, _ = _args(d)
    np_params = _random_params(jargs, seed=9)
    np_params["norm"]["weight"] = np.ones((2, 32), np.float32)
    np_params["output"]["bias"] = np.zeros((3, 259), np.float32)
    j_mask = jbase.default_wd_mask(jax.tree_util.tree_map(jnp.asarray, np_params))
    t_mask = tbase.default_wd_mask(params_from_jax(np_params, "cpu"))
    assert _torch_flat(t_mask) == {k: bool(v) for k, v in _flat_grads(j_mask).items()}
    # 7 matrices in each of 2 layers, the embedding, the output projection
    assert sum(_torch_flat(t_mask).values()) == 16


def test_flops_and_mfu_match_jax(tmp_path):
    from mlx_cuda_distributed_pretraining_tpu.obs import flops as jflops
    from mlx_cuda_distributed_pretraining_tpu_torch.obs import flops as tflops

    d = _config_dict(tmp_path)
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    want = jflops.model_flops_per_token(jcfg.model, 26880, SEQ)
    assert tflops.model_flops_per_token(tcfg.model, 26880, SEQ) == want
    peak = tflops.peak_flops_per_chip("NVIDIA H100 80GB HBM3")
    assert peak == 989e12
    assert tflops.mfu(1.5e5, want, peak, 1) == jflops.mfu(1.5e5, want, peak, 1)
    assert tflops.peak_flops_per_chip("cpu") is None
    assert tflops.mfu(1.5e5, want, None, 1) is None


@pytest.mark.parametrize("amsgrad", [False, True])
def test_fused_adamw_matches_jax(amsgrad):
    rng = np.random.default_rng(0)
    tree = {"layers": [{"attention": {"wq": {"weight": (8, 6)}},
                        "attention_norm": {"weight": (8,)}}],
            "tok_embeddings": {"weight": (11, 8)},
            "output": {"bias": (11,)}}
    shapes = jax.tree_util.tree_map(lambda s: s, tree,
                                    is_leaf=lambda x: isinstance(x, tuple))
    np_params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(
        lambda s: (3.0 * rng.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple)) for _ in range(5)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05, grad_clip=1.0,
              amsgrad=amsgrad)
    j_opt = jfused.fused_adamw(jsched.warmup_cosine(6e-4, 20, 3, 6e-5), **kw)
    t_opt = tfused.fused_adamw(tsched.warmup_cosine(6e-4, 20, 3, 6e-5), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, "cpu")
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_apply = jax.jit(j_opt.fused_apply)
    for g in grads:
        jp, js = j_apply(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.fused_apply(params_from_jax(g, "cpu"), ts, tp)
    trees = {"params": (jp, tp), "mu": (js[1]["mu"], ts[1]["mu"]),
             "nu": (js[1]["nu"], ts[1]["nu"])}
    if amsgrad:
        trees["nu_max"] = (js[1]["nu_max"], ts[1]["nu_max"])
    for name, (j, t) in trees.items():
        jf, tf_ = _flat_grads(j), {k: v.numpy() for k, v in _torch_flat(t).items()}
        for key in jf:
            np.testing.assert_allclose(tf_[key], jf[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {key}")
    assert int(ts[1]["count"]) == int(js[1]["count"]) == 5
    assert int(ts[3]["count"]) == int(js[3]["count"]) == 5


@pytest.mark.parametrize("kind,extra", [
    ("cosine_with_warmup", {"warmup_steps": 7}),
    ("cosine", {}),
    ("linear", {}),
])
def test_schedules_match_jax(tmp_path, kind, extra):
    d = _config_dict(tmp_path)
    d["training"]["scheduler"] = {"type": kind, "min_lr_ratio": 0.1, **extra}
    j_sched = jsched.build_schedule(JConfig.from_dict(d).training, 50)
    t_sched = tsched.build_schedule(TConfig.from_dict(d).training, 50)
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 60):
        # Op by op, JAX rounds every fp32 operation as PyTorch does: the
        # same bits. (Under jit, XLA's CPU compiler contracts
        # ``end + diff * frac`` into a fused multiply-add that rounds once;
        # with the cancellation near the end of a decay that moves the
        # value by a few ulps.)
        want = np.float32(j_sched(jnp.int32(step)))
        got = t_sched(step)
        assert got.dtype == torch.float32
        assert np.float32(got.item()) == want, (kind, step)
        assert tsched.schedule_value(t_sched, step) == got.item()


def test_data_rows_and_batches_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "δέλτα", "epsilon", "zeta!"]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(1, 60))))
            for _ in range(60)]
    _write_jsonl(tmp_path / "train.jsonl", docs)
    _write_jsonl(tmp_path / "val.jsonl", docs[:20])
    d = _config_dict(tmp_path)
    d["data"].update(input_file=str(tmp_path / "train.jsonl"),
                     validation_file=str(tmp_path / "val.jsonl"))
    d["data"]["preprocessing"]["chunk_overlap"] = 8
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jd = JData(jcfg.data, JTok(jcfg.data), 4, seq_len=SEQ, seed=3)
    td = TData(tcfg.data, TTok(tcfg.data), 4, seq_len=SEQ, seed=3)
    np.testing.assert_array_equal(td.train_rows, jd.train_rows)
    np.testing.assert_array_equal(td.val_rows, jd.val_rows)
    assert td.batches_per_epoch == jd.batches_per_epoch
    for k in (0, 1, td.batches_per_epoch - 1, td.batches_per_epoch, 37):
        jb, tb = jd.generate_batch(k), td.generate_batch(k)
        for key in ("inputs", "targets", "mask"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=f"{key} {k}")
    for jb, tb in zip(jd.iter_validation(), td.iter_validation()):
        np.testing.assert_array_equal(tb["inputs"], jb["inputs"])
    assert td.state_dict() == jd.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(tmp_path, accum):
    d = _config_dict(tmp_path)
    # The 40m-adamw config's rate. (At the tiny config's 1e-2, Adam, which
    # divides each gradient by its own RMS, turns the 1e-7 summation-order
    # difference of near-zero gradient entries into visible weight
    # differences within five steps.)
    d["training"]["hyperparameters"]["learning_rate"] = 6e-4
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jargs, targs = _args(d)
    np_params = _random_params(jargs, seed=4)
    j_opt = jfactory.build_optimizer(jcfg.training, 20)
    t_opt = tfactory.build_optimizer(tcfg.training, 20)

    def j_loss(p, b):
        return jl.loss_fn(p, b, jargs, compute_dtype=jnp.float32)

    def t_loss(p, b):
        return tl.loss_fn(p, b, targs, compute_dtype=torch.float32)

    j_step, _ = jts.make_train_step(j_loss, j_opt, accum_steps=accum,
                                    log_grad_norm=True)
    t_step = tts.make_train_step(t_loss, t_opt, accum_steps=accum,
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
        assert int(tm["nonfinite"]) == 0
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert ts["step"] == int(js["step"]) == 5
    # An entry whose gradients sit at zero takes Adam steps whose sign the
    # summation order decides, each at most lr: a handful of such entries
    # may differ by up to lr, the rest agree to 1e-5.
    jf = _flat_grads(js["params"])
    for key, t in _torch_flat(ts["params"]).items():
        t = t.detach().numpy()
        assert np.isclose(t, jf[key], rtol=1e-5, atol=1e-6).mean() > 0.995, key
        np.testing.assert_allclose(t, jf[key], atol=6e-4, err_msg=key)


def _step_losses(log: str):
    out = []
    for line in log.splitlines():
        if line.startswith("Step") and "validation:" not in line and "loss=" in line:
            out.append((int(line.split()[1][:-1]),
                        float(line.split("loss=")[1].split(" |")[0])))
            assert "toks=" in line and "mfu=" in line
    return out


def test_trainer_runs_and_its_run_loads_in_jax(tmp_path):
    d = _config_dict(tmp_path)
    runs = tmp_path / "runs"
    tr = Trainer(TConfig.from_dict(d), runs_root=str(runs), quiet=True,
                 device="cpu")
    result = tr.train()
    assert result["steps"] == 30

    # The log protocol parses as tests/test_trainer.py parses it.
    log = open(os.path.join(tr.run_dir, "log.txt")).read()
    steps = _step_losses(log)
    assert [s for s, _ in steps] == [5, 10, 15, 20, 25, 30]
    assert result["final_loss"] < 0.7 * steps[0][1]
    assert "validation: val_loss=" in log

    # The run directory both packages read.
    for name in ("config.yaml", "metadata.json", "tokenizer/byte_tokenizer.json"):
        assert os.path.isfile(os.path.join(tr.run_dir, name)), name
    ckpts = set(os.listdir(os.path.join(tr.run_dir, "checkpoints")))
    for name in ("step_final_model.safetensors", "step_final_optimizer.safetensors",
                 "step_final.manifest.json", "step_15_state.json",
                 "step_15_model.safetensors", "step_15.manifest.json",
                 "step_30_state.json"):
        assert name in ckpts, name
    assert tr.checkpoints.verify("final") == (True, "ok")
    assert tr.checkpoints.verify(15) == (True, "ok")

    # config.yaml is JSON that PyYAML reads back to the same values.
    raw = yaml.safe_load(open(os.path.join(tr.run_dir, "config.yaml")))
    assert raw == json.load(open(os.path.join(tr.run_dir, "config.yaml")))
    assert isinstance(raw["training"]["hyperparameters"]["learning_rate"], float)
    assert isinstance(raw["model"]["normalization"].get("rms_norm_eps", 1e-5), float)

    # The JAX package's load_trained serves the port's run; the greedy
    # logits of one prompt agree with the port's (fp32, order only).
    jp, jargs, jtok, _ = j_load_trained(tr.run_dir)
    tp, targs, ttok, _ = t_load_trained(tr.run_dir, device="cpu")
    assert jargs.attention_type == targs.attention_type == "flash"
    prompt = [ttok.bos_id] + ttok.tokenize("the quick brown fox")
    assert prompt == [jtok.bos_id] + jtok.tokenize("the quick brown fox")
    j_logits, _ = jl.forward(jp, jnp.asarray([prompt], jnp.int32), jargs)
    with torch.no_grad():
        t_logits, _ = tl.forward(tp, torch.tensor([prompt]), targs)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-5, rtol=1e-5)
    assert int(t_logits[0, -1].argmax()) == int(np.argmax(j_logits[0, -1]))


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # expert parallelism beside tp is ROADMAP queue 1 item 10b-tp (dp, fsdp
    # and ep meshes train over several ranks: tests/test_torch_dist_train.py,
    # test_torch_ep_train.py; a mesh that resolves to one device trains:
    # test_torch_moe_train).
    d = _config_dict(tmp_path)
    d["model"]["moe"] = {"num_local_experts": 4, "num_experts_per_tok": 2}
    d["system"]["mesh"] = {"dp": -1, "ep": 2, "tp": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10b-tp"):
        Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r1"),
                quiet=True, device="cpu")
    # (every optimizer of the JAX factory trains now:
    # tests/test_torch_optimizers.py; so does streaming data, refused here
    # before: tests/test_torch_streaming.py. A streaming section without
    # shards or a streaming source keeps the in-memory loader, as the JAX
    # package's build_data_manager does.)
    d = _config_dict(tmp_path)
    d["data"]["streaming"] = {"enabled": True}
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r2"),
                 quiet=True, device="cpu")
    assert type(tr.data) is TData
    # overlap_gather schedules an fsdp mesh's all-gathers, which JAX runs
    # only on an fsdp axis > 1 (over several ranks:
    # tests/test_torch_dist_train.py), and on one device the switch trains
    # the plain layer loop, as in JAX
    # (test_overlap_gather_on_one_device_trains_as_jax; remat, scan_layers
    # and the fused CE, refused here before, train too:
    # tests/test_torch_remat.py)
    d = _config_dict(tmp_path, iters=2)
    d["system"]["overlap_gather"] = True
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r3"),
                 quiet=True, device="cpu")
    assert tr.train()["steps"] == 2
    # an fsdp axis of 2 on a world of one rank: JAX's mesh_axis_sizes error
    d["system"]["mesh"] = {"fsdp": 2}
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "r4"),
                quiet=True, device="cpu")


def test_overlap_gather_on_one_device_trains_as_jax(tmp_path, monkeypatch):
    """``configs/model-config-1b-fsdp.yaml``'s switches (``mesh: {fsdp: -1}``,
    ``overlap_gather``) on one device, at the sample config cut to 2 layers
    of hidden 32: JAX's ``can_overlap`` finds no fsdp axis > 1 and runs the
    plain loop; the port trains the same 5 steps from JAX's initial weights
    (carried across with ``convert.params_from_jax``), losses within 1e-5."""
    import mlx_cuda_distributed_pretraining_tpu.train.trainer as jtrainer
    from mlx_cuda_distributed_pretraining_tpu.parallel import mesh as jmesh

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "model-config-sample.yaml")) as f:
        d = yaml.safe_load(f)
    tiny = _config_dict(tmp_path, name="overlap1", iters=5)
    d["name"], d["data"] = tiny["name"], tiny["data"]
    d["model"]["dimensions"] = {"hidden_size": 32, "intermediate_size": 64,
                                "num_layers": 2}
    d["model"]["attention"].update(num_heads=4, max_position_embeddings=SEQ)
    d["training"]["hyperparameters"].update(batch_size=4, iters=5)
    d["training"]["epochs"] = None
    d["logging"] = {"steps": {"logging_interval": 1, "checkpoint_interval": 100,
                              "validation_interval": 0}}
    d["system"] = {"seed": 0, "device": "cpu", "mesh": {"fsdp": -1},
                   "overlap_gather": True, "scan_layers": True}
    # one device, as on one card (the harness's CPU platform has eight)
    monkeypatch.setattr(jtrainer, "build_mesh", lambda system_cfg: jmesh.build_mesh(
        system_cfg, devices=jax.devices()[:1]))

    def capture(trainer):
        out = {}
        real = trainer.logger.log_metrics

        def log_metrics(step, line):
            out[step] = float(line["loss"])
            real(step, line)

        trainer.logger.log_metrics = log_metrics
        return out

    jtr = jtrainer.Trainer(JConfig.from_dict(d), runs_root=str(tmp_path / "jr"),
                           quiet=True)
    assert jtr.mesh.shape == {"fsdp": 1} and jtr.overlap_gather
    start = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    ttr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "tr"), quiet=True,
                  device="cpu")
    with torch.no_grad():
        src = _torch_flat(params_from_jax(start, "cpu"))
        live = _torch_flat(ttr.state["params"])
        assert sorted(src) == sorted(live)
        for key, leaf in live.items():
            leaf.copy_(src[key])
    want, got = capture(jtr), capture(ttr)
    jtr.train()
    assert ttr.train()["steps"] == 5
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([got[s] for s in range(1, 6)],
                               [want[s] for s in range(1, 6)], rtol=1e-5)


# (config path, value, ROADMAP queue 1 item that ported it): switches with
# which the JAX trainer generates samples. The port refused them until that
# item landed; each now trains, logs its samples at the validation steps,
# and leaves the losses as they are with the switch off. (Early stopping and
# checkpoint retention, once refused here, act now:
# tests/test_torch_resume.py; so does the LR finder:
# tests/test_torch_lr_finder.py.)
UNPORTED_SWITCHES = [
    ("logging.log_samples", True, 7),
]


@pytest.mark.parametrize("path,value,item", UNPORTED_SWITCHES)
def test_trainer_refuses_switches_that_change_the_run(tmp_path, path, value, item):
    d = _config_dict(tmp_path, iters=10)
    section, key = path.split(".")
    d[section][key] = value
    on = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "on"), quiet=True,
                 device="cpu")
    on.train()
    with open(os.path.join(on.run_dir, "log.txt")) as f:
        samples = [line for line in f if " sample: " in line]
    assert len(samples) == 1 and samples[0].startswith(
        "Step 10 sample: 'Once upon a time' -> '")
    # switched off, the same run logs no sample and the same losses
    d[section][key] = False
    off = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "off"), quiet=True,
                  device="cpu")
    off.train()
    assert [w["loss"] for w in on.windows] == [w["loss"] for w in off.windows]


def test_log_samples_line_matches_jax(tmp_path):
    # the trainer's sample line on the same weights as the JAX package's
    # greedy generate_text written by the JAX logger
    from mlx_cuda_distributed_pretraining_tpu.infer.generate import (
        generate_text as j_generate_text,
    )
    from mlx_cuda_distributed_pretraining_tpu.obs.logger import Logger as JLogger
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_into

    d = _config_dict(tmp_path)
    d["logging"]["log_samples"] = True
    jargs, _ = _args(d)
    np_params = _random_params(jargs, seed=11)
    tr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                 device="cpu")
    load_into(tr.state["params"], params_from_jax(np_params, "cpu"))
    tr.generate_samples(10)
    jlogger = JLogger(str(tmp_path / "jax"), quiet=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jlogger.log_sample(10, "Once upon a time", j_generate_text(
        jparams, jargs, JTok(JConfig.from_dict(d).data), "Once upon a time",
        max_new_tokens=48, temperature=0.0))
    jlogger.close()

    def sample_lines(path):
        with open(path) as f:
            return [line for line in f if " sample: " in line]

    got = sample_lines(os.path.join(tr.run_dir, "log.txt"))
    assert got == sample_lines(str(tmp_path / "jax" / "log.txt")) and len(got) == 1
    assert len(got[0]) > len("Step 10 sample: 'Once upon a time' -> ''\n") + 10


def test_unknown_architecture_raises_as_in_jax(tmp_path):
    from mlx_cuda_distributed_pretraining_tpu.models.registry import (
        resolve_architecture as j_resolve,
    )

    d = _config_dict(tmp_path)
    d["model"]["architecture"] = "lama_typo"
    with pytest.raises(ValueError) as jerr:
        j_resolve("lama_typo")
    with pytest.raises(ValueError) as terr:
        Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "runs"), quiet=True,
                device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "unknown architecture 'lama_typo'" in str(terr.value)
    # a finished run whose config names an unknown architecture does not load
    tr = Trainer(TConfig.from_dict(_config_dict(tmp_path, iters=1)),
                 runs_root=str(tmp_path / "runs"), quiet=True, device="cpu")
    tr.train()
    cfg_path = os.path.join(tr.run_dir, "config.yaml")
    raw = json.load(open(cfg_path))
    raw["model"]["architecture"] = "lama_typo"
    json.dump(raw, open(cfg_path, "w"))
    with pytest.raises(ValueError, match="unknown architecture"):
        t_load_trained(tr.run_dir, device="cpu")


@pytest.mark.parametrize("arch", ["llama", "llama_standard", "llama_flash", "LLaMA_Flash"])
@pytest.mark.parametrize("flash", [False, True])
def test_architecture_sets_attention_as_the_jax_trainer(tmp_path, arch, flash):
    from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer

    d = _config_dict(tmp_path, flash=flash)
    d["model"]["architecture"] = arch
    jtr = JTrainer(JConfig.from_dict(d), for_training=False,
                   runs_root=str(tmp_path / "jruns"), quiet=True)
    ttr = Trainer(TConfig.from_dict(d), runs_root=str(tmp_path / "truns"), quiet=True,
                  device="cpu")
    assert ttr.model_args.attention_type == jtr.model_args.attention_type
    forced = {"llama_standard": "simple", "llama_flash": "flash"}.get(arch.lower())
    assert ttr.model_args.attention_type == (forced or ("flash" if flash else "simple"))
    assert ttr.arch.name == jtr.arch.name


def test_bf16_embedding_gradient_sums_a_tokens_rows_in_fp32():
    # Under bf16 compute the gradients of a frequent token's rows are summed
    # into the fp32 table: summed in bf16 (the cast table's own gradient),
    # 4,096 rows of one token lost ~7% of the table's gradient here, and a
    # fifth of its norm at moe-1b's step 1 on the card.
    g = torch.Generator().manual_seed(0)
    V, D = 16, 64
    w = (torch.randn(V, D, generator=g) * 0.02).requires_grad_(True)
    tokens = torch.zeros(1, 4096, dtype=torch.long)
    tokens[0, ::7] = torch.randint(1, V, (len(range(0, 4096, 7)),), generator=g)
    dy = torch.randn(1, 4096, D, generator=g).to(torch.bfloat16)
    x = tl.embed({"tok_embeddings": {"weight": w}}, tokens,
                 tl.LlamaArgs(vocab_size=V, hidden_size=D), torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, w.detach().to(torch.bfloat16)[tokens])  # JAX's values
    x.backward(dy)
    want = torch.zeros(V, D, dtype=torch.float64).index_add_(0, tokens[0], dy[0].double())
    err = (w.grad.double() - want).norm() / want.norm()
    assert err < 1e-6, err
