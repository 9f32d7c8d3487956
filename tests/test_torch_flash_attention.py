"""The torch port's flash attention against the JAX package's, on the CPU.

On the CPU the port runs the kernels' plain versions under its custom
backward; the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` does (B 2, S 256, D 32, 64-row blocks).
Inputs are numpy from a seed. fp32 throughout: the forward agrees to 2e-5
and the gradients to atol 5e-4 / rtol 5e-3 (the JAX suite's own flash vs
reference tolerances; both sides sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.ops import flash_attention as jf
from mlx_cuda_distributed_pretraining_tpu.ops import masks as JM
from mlx_cuda_distributed_pretraining_tpu.ops.attention import (
    reference_attention as j_reference,
)
from mlx_cuda_distributed_pretraining_tpu_torch.ops import flash_attention as tf
from mlx_cuda_distributed_pretraining_tpu_torch.ops import kernel_check
from mlx_cuda_distributed_pretraining_tpu_torch.ops import masks as TM
from mlx_cuda_distributed_pretraining_tpu_torch.ops.attention import (
    reference_attention as t_reference,
)

B, S, D = 2, 256, 32
BLOCK = 64
WINDOW, PREFIX = 96, 80
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)


def _qkv(hq=4, hkv=4, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, h, D)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _jax_flash(q, k, v, mask_type):
    return jf.flash_attention(q, k, v, mask_type=mask_type, window_size=WINDOW,
                              prefix_len=PREFIX, block_q=BLOCK, block_kv=BLOCK)


def _port_flash(q, k, v, mask_type):
    return tf.flash_attention(q, k, v, mask_type=mask_type, window_size=WINDOW,
                              prefix_len=PREFIX)


CASES = [  # (mask, hq, hkv, s)
    ("causal", 4, 4, S), ("sliding_window", 4, 4, S), ("prefix_lm", 4, 4, S),
    ("full", 4, 4, S), ("causal", 4, 2, S), ("causal", 4, 1, S),
    ("causal", 4, 2, 200),
]


@pytest.mark.parametrize("mask_type,hq,hkv,s", CASES)
def test_flash_attention_forward_and_grads_match_jax(mask_type, hq, hkv, s):
    q, k, v = _qkv(hq, hkv, s)
    j_out = _jax_flash(*map(jnp.asarray, (q, k, v)), mask_type)

    def j_loss(q, k, v):
        o = _jax_flash(q, k, v, mask_type)
        return jnp.sum(o * jnp.cos(o))  # a nontrivial cotangent

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    t_out = _port_flash(tq, tk, tv, mask_type)
    (t_out * torch.cos(t_out)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    for name, jg, t in zip("qkv", j_grads, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=f"d{name} ({mask_type}, {hq}/{hkv}, S={s})")


@pytest.mark.parametrize("mask_type", ["causal", "sliding_window", "prefix_lm", "full"])
def test_raw_plain_functions_match_jax_kernels(mask_type):
    """flash_fwd_plain (o, lse), flash_bwd_dq_plain and flash_bwd_dkv_plain
    against the raw interpret-mode kernels on the same lse and delta, GQA
    4/2, [B, H, S, D] layout."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _qkv(4, 2))
    do = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    mask_fn = {"causal": JM.causal(), "sliding_window": JM.sliding_window(WINDOW),
               "prefix_lm": JM.prefix_lm(PREFIX), "full": None}[mask_type]
    kw = dict(mask_type=mask_type, window=WINDOW, prefix_len=PREFIX,
              scale=D ** -0.5)
    jkw = dict(kw, mask_fn=mask_fn, block_q=BLOCK, block_kv=BLOCK)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    j_o, j_lse = jf.flash_fwd(jq, jk, jv, **jkw)
    t_o, t_lse = tf.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), **FWD_TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, :, 0], **FWD_TOL)

    lse = np.asarray(j_lse)
    delta = np.sum(do * np.asarray(j_o), axis=-1)[:, :, None, :]
    j_dq = jf.flash_bwd_dq(jq, jk, jv, jdo, jnp.asarray(lse), jnp.asarray(delta), **jkw)
    j_dk, j_dv = jf.flash_bwd_dkv(jq, jk, jv, jdo, jnp.asarray(lse),
                                  jnp.asarray(delta), **jkw)
    targs = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (q, k, v, do, lse[:, :, 0], delta[:, :, 0])]
    t_dq = tf.flash_bwd_dq_plain(*targs, **kw)
    t_dk, t_dv = tf.flash_bwd_dkv_plain(*targs, **kw)
    for t, j in ((t_dq, j_dq), (t_dk, j_dk), (t_dv, j_dv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("mask_type", ["causal", "sliding_window", "prefix_lm",
                                       "full", "band"])
def test_tile_planners_match_jax(mask_type):
    for bq, bkv in ((64, 64), (32, 64), (64, 32), (256, 512)):
        for n in (1, 2, 5, 16):
            for window, prefix in ((1, 0), (96, 80), (300, 1000), (-40, 0)):
                args = (mask_type, window, prefix, bq, bkv)
                jlo, jhi = jf._kv_range(*args, n)
                tlo, thi = tf._kv_range(*args, n)
                assert [(int(jlo(i)), int(jhi(i))) for i in range(n)] == \
                    [(tlo(i), thi(i)) for i in range(n)], (args, n)
                jlo, jhi = jf._q_range(*args, n)
                tlo, thi = tf._q_range(*args, n)
                assert [(int(jlo(i)), int(jhi(i))) for i in range(n)] == \
                    [(tlo(i), thi(i)) for i in range(n)], (args, n)
                jfull = jf._full_tile_fn(*args)
                tfull = tf._full_tile_fn(*args)
                assert (jfull is None) == (tfull is None)
                if jfull is not None:
                    assert [[bool(jfull(i, j)) for j in range(n)] for i in range(n)] \
                        == [[bool(tfull(i, j)) for j in range(n)] for i in range(n)]
    for block in (64, 128, 256, 512, 1024):
        for dim in (64, 128, 192, 200, 1000, 1024, 4096):
            assert tf.fit_block(block, dim) == jf.fit_block(block, dim)


@pytest.mark.parametrize("mask_type", ["causal", "sliding_window", "prefix_lm", "full"])
def test_reference_attention_with_mask_mod_matches_jax(mask_type):
    q, k, v = _qkv(4, 2, 64)
    jmod = {"causal": JM.causal(), "sliding_window": JM.sliding_window(24),
            "prefix_lm": JM.prefix_lm(20), "full": JM.full()}[mask_type]
    tmod = {"causal": TM.causal(), "sliding_window": TM.sliding_window(24),
            "prefix_lm": TM.prefix_lm(20), "full": TM.full()}[mask_type]
    assert tmod._plan == jmod._plan
    j = j_reference(*map(jnp.asarray, (q, k, v)), mask_mod=jmod)
    t = t_reference(*map(torch.from_numpy, (q, k, v)), mask_mod=tmod)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_unported_options_raise():
    # band, the named mask mods, the flex score mods and int8 are ported
    # (tests/test_torch_flex.py, tests/test_torch_int8_train.py); a mask mod
    # without a plan, a plan other than the named mask and a score mod
    # without a kernel code raise
    q, k, v = (torch.zeros(1, 8, 2, 64) for _ in range(3))
    assert torch.isfinite(tf.flash_attention(q, k, v, precision="int8")).all()
    for kw in ({"mask_fn": lambda r, c: r >= c},
               {"mask_fn": TM.sliding_window(4)},
               {"score_fn": lambda s, r, c, h: s}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
            tf.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="mask_type"):
        tf.flash_attention(q, k, v, mask_type="diagonal")


def test_kernel_check_passes_bf16_rounding_and_rejects_a_skipped_tile():
    # The kernels' gate (kernel_check.compare) at the training path's S, D
    # and causal mask. The bf16 plain forward stands for the reference;
    # the same inputs in fp32, with p left unrounded and the output rounded
    # once to bf16, differ from it by rounding alone, as a correct kernel
    # does, and must pass. The planted fault leaves the diagonal KV tile
    # out of the last 64-row Q tile (those rows then see every earlier key,
    # a full mask over them) and must fail.
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 1024, 64))
                                .astype(np.float32)).bfloat16() for _ in range(3))
    kw = dict(mask_type="causal", scale=64 ** -0.5)
    ref, _ = tf.flash_fwd_plain(q, k, v, **kw)
    rounded = tf.flash_fwd_plain(q.float(), k.float(), v.float(), **kw)[0]
    good = kernel_check.compare(rounded.bfloat16(), ref)
    assert good["ok"], good
    bad = ref.clone()
    bad[:, :, -64:] = tf.flash_fwd_plain(q[:, :, -64:], k[:, :, :-64],
                                         v[:, :, :-64], mask_type="full",
                                         scale=64 ** -0.5)[0]
    fault = kernel_check.compare(bad, ref)
    assert not fault["ok"] and fault["limit_ratio"] > 10, fault


def test_no_worse_than_plain_holds_a_kernel_to_float64_beside_the_plain_version():
    # kernel_check.no_worse_than_plain arbitrates a bf16 miss: a dQ that
    # rounds at other points than the bf16 plain version (here: computed in
    # fp32, rounded once) is within the bf16 limit of the plain version's
    # distance from the float64 evaluation and passes; the planted fault
    # (the last 64 rows' dQ zeroed) is far past it and fails.
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 4, 256, 32))
                                    .astype(np.float32)).bfloat16() for _ in range(4))
    kw = dict(mask_type="causal", scale=32 ** -0.5)
    o, lse = tf.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    plain = tf.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    exact = tf.flash_bwd_dq_plain(q.double(), k.double(), v.double(), do.double(),
                                  lse.double(), delta.double(), **kw)
    f32 = tf.flash_bwd_dq_plain(q.float(), k.float(), v.float(), do.float(), lse,
                                delta, **kw).bfloat16()
    good = kernel_check.no_worse_than_plain(f32, plain, exact)
    assert good["ok"] and good["limit_ratio"] <= 1.0, good
    bad = plain.clone()
    bad[:, :, -64:] = 0
    fault = kernel_check.no_worse_than_plain(bad, plain, exact)
    assert not fault["ok"] and fault["limit_ratio"] > 10, fault


def test_planted_fault_drops_one_tile_and_restores_the_plan():
    plan = tf._plan("causal", 0, 0, 1024, 64, torch.device("cpu"))
    with kernel_check.planted_fault():
        kv, q_ranges, full = tf._plan("causal", 0, 0, 1024, 64, torch.device("cpu"))
    assert kv[:-1].tolist() == plan[0][:-1].tolist()
    assert kv[-1].tolist() == [0, 15] and plan[0][-1].tolist() == [0, 16]
    assert q_ranges[1:].tolist() == plan[1][1:].tolist()
    assert q_ranges[0].tolist() == [0, 15] and plan[1][0].tolist() == [0, 16]
    assert full is plan[2]
    assert tf._plan("causal", 0, 0, 1024, 64, torch.device("cpu"))[0] is plan[0]


def _meta_inputs(dtype=torch.bfloat16, d=64):
    q, k, v, do = (torch.empty((2, 4, 128, d), dtype=dtype, device="meta")
                   for _ in range(4))
    lse, delta = (torch.empty((2, 4, 128), device="meta") for _ in range(2))
    return q, k, v, do, lse, delta


def test_flash_non_cpu_input_raises_instead_of_falling_back():
    # A tensor that is not on the CPU never takes the plain version: on a
    # device the kernels cannot take it raises before any build or launch.
    q, k, v, do, lse, delta = _meta_inputs()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.flash_bwd_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.flash_bwd_dkv(q, k, v, do, lse, delta)


def test_flash_kernel_path_without_nvcc_raises(monkeypatch, tmp_path):
    # Inputs that pass the kernels' checks (waived here for meta tensors
    # standing in for CUDA ones) go to the build, which raises without
    # nvcc; nothing catches it to run the plain version.
    import torch.utils.cpp_extension as cpp

    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tf, "_libs", {})
    monkeypatch.setattr(tf, "_check", lambda *a: None)
    monkeypatch.setattr(tf, "_plan", lambda *a: (None, None, torch.zeros(2, 2)))
    q, k, v, do, lse, delta = _meta_inputs()
    before = (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkv.launches)
    for call in (lambda: tf.flash_fwd(q, k, v),
                 lambda: tf.flash_bwd_dq(q, k, v, do, lse, delta),
                 lambda: tf.flash_bwd_dkv(q, k, v, do, lse, delta)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("fn", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_flash_variant_for_every_kernel_dtype_and_head_dim(fn, dtype, head_dim):
    # bf16 takes the TMA/wgmma kernels, all three at every head dim; fp32
    # the "f32" ones (all three on 3xTF32 mma.sync); each variant plans at
    # its own tiles.
    got = tf.flash_variant(fn, getattr(torch, dtype), head_dim)
    want = "f32" if dtype == "float32" else "wgmma"
    assert got == want
    assert tf.WGMMA_HEAD_DIMS == dict.fromkeys(tf.FLASH_KERNELS, (16, 32, 64, 128))
    assert tf.kernel_tiles(fn, got, head_dim) == {
        ("flash_fwd", "wgmma"): (128, 128),
        ("flash_bwd_dq", "wgmma"): (128, tf._DQ_BKV.get(head_dim)),
        ("flash_bwd_dkv", "wgmma"): (tf._DKV_BQ.get(head_dim), 128),
        ("flash_fwd", "f32"): (tf._F32_BQ, tf._F32_BKV.get(head_dim)),
        ("flash_bwd_dq", "f32"): (tf._F32_DQ_BQ, tf._F32_DQ_BKV.get(head_dim)),
        ("flash_bwd_dkv", "f32"): (tf._F32_DKV_BQ.get(head_dim), tf._F32_DKV_BKV),
    }[(fn, got)]
    # the bf16 WMMA and SIMT kernels are gone: no variant and no C entry
    # code names them
    assert tf.FLASH_VARIANTS == ("wgmma", "f32")
    assert tf._VARIANT_CODES == {"f32": 0, "wgmma": 2}


def test_flash_variant_rejects_what_no_kernel_takes():
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tf.flash_variant("flash_fwd", torch.float16, 64)
    with pytest.raises(ValueError, match="unknown flash kernel"):
        tf.flash_variant("flash_bwd", torch.bfloat16, 64)
    with pytest.raises(ValueError, match="no bf16 kernel at head dim 48"):
        tf.flash_variant("flash_bwd_dq", torch.bfloat16, 48)


def test_kernel_tiles_match_the_cuda_source():
    # The wgmma launchers refuse a plan at other sizes; the CPU side reads
    # the same constants the kernels are compiled with.
    import re

    src = tf._SRC.read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert tf.kernel_tiles("flash_fwd", "wgmma") == (const["FWD_BQ"], const["FWD_BKV"])
    for d in tf.WGMMA_HEAD_DIMS["flash_bwd_dq"]:
        assert tf.kernel_tiles("flash_bwd_dq", "wgmma", d) == (
            const["DQ_BQ"], const[f"DQ_BKV_D{d}"])
    for d in tf.WGMMA_HEAD_DIMS["flash_bwd_dkv"]:
        assert tf.kernel_tiles("flash_bwd_dkv", "wgmma", d) == (
            const[f"DKV_BQ_D{d}"], const["DKV_BKV"])


def test_dq_and_fp32_forward_tiles_match_the_cuda_source():
    # _DQ_BKV (every head dim) and the fp32 kernels' tiles (forward, dQ and
    # dK/dV) are the constexprs the kernels are compiled with and check the
    # plan against.
    import re

    src = tf._SRC.read_text() + tf._SRC_F32.read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert tf._DQ_BKV == {d: const[f"DQ_BKV_D{d}"] for d in (16, 32, 64, 128)}
    for d in (16, 32, 64, 128):
        assert tf.kernel_tiles("flash_fwd", "f32", d) == (const["F32_BQ"],
                                                          const[f"F32_BKV_D{d}"])
        assert tf.kernel_tiles("flash_bwd_dq", "f32", d) == (const["F32_DQ_BQ"],
                                                             const[f"F32_DQ_BKV_D{d}"])
        assert tf.kernel_tiles("flash_bwd_dkv", "f32", d) == (const[f"F32_DKV_BQ_D{d}"],
                                                              const["F32_DKV_BKV"])


# The tiles the redesigned kernels plan at: the wgmma dQ at D 16 and 32, the
# three fp32 kernels at every head dim.
F32_PLAN_TILES = sorted({tf.kernel_tiles(fn, "f32", d) for fn in tf.FLASH_KERNELS
                         for d in (16, 32, 64, 128)})
NEW_PLAN_TILES = sorted({tf.kernel_tiles("flash_bwd_dq", "wgmma", d) for d in (16, 32)}
                        | set(F32_PLAN_TILES))


@pytest.mark.parametrize("mask_type", ["causal", "sliding_window", "prefix_lm", "full", "band"])
@pytest.mark.parametrize("S", [1, 64, 127, 1000, 1024])
def test_plan_at_the_new_tiles_matches_jax_planners(mask_type, S):
    # _plan at the wgmma dQ's D 16/32 tiles and the fp32 kernels': live
    # ranges from JAX's _kv_range / _q_range, the no-mask flag from its
    # _full_tile_fn and the tile lying inside S, windows and a prefix that
    # are not multiples of a tile.
    for bq, bkv in NEW_PLAN_TILES:
        for window, prefix in ((100, 200), (300, 200)):
            kv, qr, full = tf._plan(mask_type, window, prefix, S, bq, torch.device("cpu"), bkv)
            nq, nk = -(-S // bq), -(-S // bkv)
            jlo, jhi = jf._kv_range(mask_type, window, prefix, bq, bkv, nk)
            assert kv.tolist() == [[int(jlo(i)), int(jhi(i))] for i in range(nq)]
            jlo, jhi = jf._q_range(mask_type, window, prefix, bq, bkv, nq)
            assert qr.tolist() == [[int(jlo(j)), int(jhi(j))] for j in range(nk)]
            jfull = jf._full_tile_fn(mask_type, window, prefix, bq, bkv)
            assert full.tolist() == [[int((jfull is None or bool(jfull(i, j)))
                                          and (i + 1) * bq <= S and (j + 1) * bkv <= S)
                                      for j in range(nk)] for i in range(nq)]


WGMMA_PLAN_TILES = [(128, 128), (128, 64), (64, 128)]


def test_the_planner_test_covers_every_wgmma_plan():
    # forward 128 x 128 (every head dim); dQ 128 x 128 (D 64) and 128 x 64
    # (D 16, 32, 128); dK/dV 128 x 128 (D 16, 32, 64) and 64 x 128 (D 128)
    tiles = {tf.kernel_tiles(fn, "wgmma", d) for fn in tf.FLASH_KERNELS
             for d in tf.WGMMA_HEAD_DIMS[fn]}
    assert tiles == set(WGMMA_PLAN_TILES)


@pytest.mark.parametrize("mask_type", ["causal", "sliding_window", "prefix_lm", "full"])
@pytest.mark.parametrize("S", [130, 1000, 1024])
@pytest.mark.parametrize("bq,bkv", WGMMA_PLAN_TILES)
def test_plan_at_the_wgmma_tiles_matches_jax_planners(mask_type, S, bq, bkv):
    # _plan with separate Q and KV tile sizes: live ranges from the JAX
    # _kv_range / _q_range, the no-mask flag from _full_tile_fn and the
    # tile lying inside S (windows and prefixes not multiples of a tile).
    for window, prefix in ((100, 200), (300, 200)):
        kv, qr, full = tf._plan(mask_type, window, prefix, S, bq,
                                torch.device("cpu"), bkv)
        nq, nk = -(-S // bq), -(-S // bkv)
        assert kv.shape == (nq, 2) and qr.shape == (nk, 2) and full.shape == (nq, nk)
        jlo, jhi = jf._kv_range(mask_type, window, prefix, bq, bkv, nk)
        assert kv.tolist() == [[int(jlo(i)), int(jhi(i))] for i in range(nq)]
        jlo, jhi = jf._q_range(mask_type, window, prefix, bq, bkv, nq)
        assert qr.tolist() == [[int(jlo(j)), int(jhi(j))] for j in range(nk)]
        jfull = jf._full_tile_fn(mask_type, window, prefix, bq, bkv)
        want = [[int((jfull is None or bool(jfull(i, j)))
                     and (i + 1) * bq <= S and (j + 1) * bkv <= S)
                 for j in range(nk)] for i in range(nq)]
        assert full.tolist() == want
        # every pair the mask lets through lies in a live tile, and a tile
        # flagged full has no refused pair and nothing outside S
        mod = tf._mask_mod(mask_type, window, prefix)
        valid = (torch.ones(S, S, dtype=torch.bool) if mod is None
                 else TM.materialize_mask(mod, S, S, device="cpu"))
        rows, cols = torch.nonzero(valid, as_tuple=True)
        qi, kj = rows // bq, cols // bkv
        assert bool(((kv[qi, 0] <= kj) & (kj < kv[qi, 1])).all())
        assert bool(((qr[kj, 0] <= qi) & (qi < qr[kj, 1])).all())
        for i, j in torch.nonzero(full).tolist():
            assert bool(valid[i * bq:(i + 1) * bq, j * bkv:(j + 1) * bkv].all())


@pytest.mark.parametrize("head_dim", [16, 32])
@pytest.mark.parametrize("mask_type,window", [
    ("causal", 0), ("sliding_window", 128), ("prefix_lm", 0), ("full", 0), ("band", 128)])
@pytest.mark.parametrize("S", [127, 512, 1000])
def test_small_head_dims_plan_at_the_wgmma_tiles(head_dim, mask_type, window, S):
    # At D 16 and 32 the bf16 forward, dQ and dK/dV run the wgmma kernels
    # (the forward and dK/dV at 128 x 128 tiles, dQ at 128 query rows
    # against _DQ_BKV KV rows), and their plans are the JAX planners' at
    # those tiles.
    prefix = 200
    for fn in tf.FLASH_KERNELS:
        variant = tf.flash_variant(fn, torch.bfloat16, head_dim)
        bq, bkv = tf.kernel_tiles(fn, variant, head_dim)
        want = (128, tf._DQ_BKV[head_dim]) if fn == "flash_bwd_dq" else (128, 128)
        assert (variant, (bq, bkv)) == ("wgmma", want)
        kv, qr, full = tf._plan(mask_type, window, prefix, S, bq, torch.device("cpu"), bkv)
        nq, nk = -(-S // bq), -(-S // bkv)
        jlo, jhi = jf._kv_range(mask_type, window, prefix, bq, bkv, nk)
        assert kv.tolist() == [[int(jlo(i)), int(jhi(i))] for i in range(nq)]
        jlo, jhi = jf._q_range(mask_type, window, prefix, bq, bkv, nq)
        assert qr.tolist() == [[int(jlo(j)), int(jhi(j))] for j in range(nk)]
        jfull = jf._full_tile_fn(mask_type, window, prefix, bq, bkv)
        assert full.tolist() == [[int((jfull is None or bool(jfull(i, j)))
                                      and (i + 1) * bq <= S and (j + 1) * bkv <= S)
                                  for j in range(nk)] for i in range(nq)]


def test_planted_fault_drops_one_tile_of_the_wgmma_plans():
    # The forward's and dQ's plans (128 x 128; dQ at D 128 128 x 64) lose
    # the last live KV tile of their last Q tile; dK/dV's (64 x 128 at D
    # 128) the last live Q tile of KV tile 0.
    cpu = torch.device("cpu")
    for bq, bkv in WGMMA_PLAN_TILES:
        kv0, q0, full0 = tf._plan("causal", 0, 0, 1024, bq, cpu, bkv)
        with kernel_check.planted_fault():
            kv, qr, full = tf._plan("causal", 0, 0, 1024, bq, cpu, bkv)
        live = lambda r: int((r[:, 1] - r[:, 0]).sum())  # noqa: E731
        assert live(kv) == live(kv0) - 1 and live(qr) == live(q0) - 1
        assert kv[:-1].tolist() == kv0[:-1].tolist()
        assert kv[-1].tolist() == [0, kv0[-1, 1].item() - 1]
        assert qr[1:].tolist() == q0[1:].tolist()
        assert qr[0].tolist() == [0, 1024 // bq - 1]
        assert full is full0
        assert tf._plan("causal", 0, 0, 1024, bq, cpu, bkv)[0] is kv0


def test_planted_fault_drops_one_tile_of_the_fp32_forward_plans():
    # The fp32 kernels' plans (the forward and dQ: 64 query rows against
    # 64- or 32-row KV tiles; dK/dV: 64- or 32-row Q tiles against 64 KV
    # rows) lose the last live KV tile of their last Q tile (forward, dQ)
    # and the last live Q tile of KV tile 0 (dK/dV), as the wgmma plans do.
    cpu = torch.device("cpu")
    assert {tf.kernel_tiles(fn, "f32", d)[0] for fn in ("flash_fwd", "flash_bwd_dq")
            for d in (16, 32, 64, 128)} == {64}
    assert {tf.kernel_tiles("flash_bwd_dkv", "f32", d)[1] for d in (16, 32, 64, 128)} == {64}
    for bq, bkv in F32_PLAN_TILES:
        kv0, q0 = tf._plan("causal", 0, 0, 1024, bq, cpu, bkv)[:2]
        with kernel_check.planted_fault():
            kv, qr = tf._plan("causal", 0, 0, 1024, bq, cpu, bkv)[:2]
        assert kv[:-1].tolist() == kv0[:-1].tolist()
        assert kv[-1].tolist() == [0, kv0[-1, 1].item() - 1] == [0, 1024 // bkv - 1]
        assert qr[1:].tolist() == q0[1:].tolist()
        assert qr[0].tolist() == [0, q0[0, 1].item() - 1] == [0, 1024 // bq - 1]


def test_header_edit_changes_the_library_path(monkeypatch, tmp_path):
    # Every source hashes with every csrc/*.cuh: an edited header rebuilds
    # every library; an edit elsewhere in the directory does not.
    from mlx_cuda_distributed_pretraining_tpu_torch.utils import cuda_build

    csrc = tf._SRC.parent
    for f in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    srcs = [tmp_path / "flash_attention.cu", tmp_path / "flash_attention_f32.cu",
            tmp_path / "grouped_matmul.cu"]
    assert (tmp_path / "hopper.cuh").exists()
    assert all('#include "hopper.cuh"' in s.read_text() for s in srcs)
    before = [cuda_build.library_path(s) for s in srcs]
    assert before == [cuda_build.library_path(csrc / s.name) for s in srcs]
    (tmp_path / "notes.txt").write_text("not a header")
    assert [cuda_build.library_path(s) for s in srcs] == before
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [cuda_build.library_path(s) for s in srcs]
    assert all(a != b and a.name.startswith(b.name.split("-")[0])
               for a, b in zip(after, before))


@pytest.mark.parametrize("fn", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_runs_fp32_operands_in_float64_and_bf16_as_given(fn, dtype):
    # The fp32 kernels' reference is the plain version on float64 copies of
    # every fp32 tensor (lse and delta too), cast back to fp32; with bf16
    # operands it is the plain call itself, its fp32 lse and delta untouched.
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 4, 70, 16, generator=g).to(getattr(torch, dtype))
                   for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    kw = dict(score_mod="alibi", score_arg=4.0)
    o, lse = tf.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v) if fn == "flash_fwd" else (q, k, v, do, lse, delta)
    plain = getattr(tf, fn + "_plain")

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    got = as_tuple(kernel_check.reference(plain, *args, **kw))
    if dtype == "bfloat16":
        want = as_tuple(plain(*args, **kw))
    else:
        want = tuple(t.float() for t in as_tuple(plain(*(a.double() for a in args), **kw)))
        assert not torch.equal(got[0], as_tuple(plain(*args, **kw))[0])
    assert got[0].dtype == getattr(torch, dtype)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
