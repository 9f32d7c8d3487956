"""KV export, transfer and adoption between batch engines, and the serving
fault points, in the torch port against the JAX package, on the CPU (JAX's
``tests/test_fleet.py`` / ``test_serve_chaos.py`` engine-side cases).

A GKV1 payload (``serve/kv_transfer.py``) exported by one package's engine
parses in the other's, adopts there, and the adopting request's greedy
tokens equal a fresh prefill's while its prompt is served from the adopted
blocks; fp32 and int8 pools. A corrupted payload is refused and its keys
are quarantined. The fault registry fires on the same calls as JAX's
(``nth``, ``every``, and the seeded ``rate`` hash).

Weights: ``tests/test_torch_serve.py``'s dense numpy weights (seed 0),
carried across with ``convert.params_from_jax``. Greedy tokens are
compared exactly; KV values across the packages to fp32 tolerance (1e-5),
int8 values within one grid step (a value at a rounding boundary may land
on either side of it).

The HTTP push (``push_payload``), the fleet's prefill/decode handoff and
the router are held against JAX in ``tests/test_torch_router.py``,
``test_torch_fleet.py`` and ``test_torch_server_locked.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.serve import BatchEngine as JEngine
from mlx_cuda_distributed_pretraining_tpu.serve import EngineConfig as JConfig
from mlx_cuda_distributed_pretraining_tpu.serve import faults as jfaults
from mlx_cuda_distributed_pretraining_tpu.serve.kv_transfer import (
    KVTransferPayload as JPayload,
)
from mlx_cuda_distributed_pretraining_tpu.serve.kv_transfer import _corrupt as j_corrupt
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.serve import BatchEngine, EngineConfig, faults
from mlx_cuda_distributed_pretraining_tpu_torch.serve.kv_transfer import (
    KVTransferPayload,
    _corrupt,
)
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager

from test_torch_serve import BASE, _port_args, _random_params

TOK = TokenizerManager()
JARGS = jl.LlamaArgs(**BASE, tie_word_embeddings=False)
NP_PARAMS = _random_params(JARGS, 0)
ARGS = _port_args(JARGS)
PARAMS = params_from_jax(NP_PARAMS, "cpu")
PROMPT = "The quick brown fox jumps over the lazy dog; again and again."
BLOCK = 16


def _ids():
    return [TOK.bos_id] + TOK.tokenize(PROMPT)


def _port(**kw):
    return BatchEngine(PARAMS, ARGS, TOK, EngineConfig(
        num_slots=2, max_len=128, prefill_chunk=16, block_size=BLOCK, **kw))


def _jax(**kw):
    return JEngine(jax.tree_util.tree_map(jnp.asarray, NP_PARAMS), JARGS, JTok(DataConfig()),
                   JConfig(num_slots=2, max_len=128, prefill_chunk=16, block_size=BLOCK, **kw))


def _serve(eng, max_tokens=12):
    req = eng.submit(PROMPT, max_tokens=max_tokens, temperature=0.0)
    assert req.wait(300) and req.error is None
    return list(req.tokens), req.cached_tokens


def _exported(make, quant):
    """(payload bytes, greedy tokens) from an engine that served PROMPT."""
    eng = make(kv_quant=quant).start()
    try:
        tokens, _ = _serve(eng)
        return eng.export_kv(_ids()).to_bytes(), tokens
    finally:
        eng.stop()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_gkv1_payload_adopts_across_packages(direction, quant):
    src, dst = (_port, _jax) if direction == "port_to_jax" else (_jax, _port)
    parse = JPayload.from_bytes if direction == "port_to_jax" else KVTransferPayload.from_bytes
    data, fresh = _exported(src, quant)
    payload = parse(data)
    assert payload.num_blocks == len(_ids()) // BLOCK >= 2
    assert payload.quantized == quant
    eng = dst(kv_quant=quant).start()
    try:
        stats = eng.adopt_kv(payload)
        assert stats == {"adopted": payload.num_blocks, "reused": 0, "skipped": 0}
        tokens, cached = _serve(eng)
    finally:
        eng.stop()
    assert tokens == fresh
    assert cached == payload.num_blocks * BLOCK


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_port_payload_bytes_are_jax_layout(quant):
    port_data, _ = _exported(_port, quant)
    jax_data, _ = _exported(_jax, quant)
    a, b = KVTransferPayload.from_bytes(port_data), JPayload.from_bytes(jax_data)
    assert len(port_data) == len(jax_data)
    assert a.keys == b.keys and a.token_ids == b.token_ids
    assert a.block_size == b.block_size and a.quantized == b.quantized
    hlen = int.from_bytes(port_data[4:8], "little")
    assert port_data[:8 + hlen] == jax_data[:8 + hlen]  # header byte for byte
    for blk_a, blk_b in zip(a.blocks, b.blocks):
        for la, lb in zip(blk_a, blk_b):
            assert sorted(la) == sorted(lb)
            for name in la:
                assert la[name].dtype == lb[name].dtype and la[name].shape == lb[name].shape
                if name.endswith("_q"):  # int8 values: at most one grid step apart
                    assert np.abs(la[name].astype(int) - lb[name].astype(int)).max() <= 1
                else:
                    np.testing.assert_allclose(la[name], lb[name], rtol=1e-5, atol=1e-5)
    assert KVTransferPayload.from_bytes(a.to_bytes()).to_bytes() == port_data


def test_corrupt_payload_is_refused_and_quarantined():
    data, fresh = _exported(_port, False)
    bad = _corrupt(data)
    assert bad == j_corrupt(data) and len(bad) == len(data)
    for parse in (KVTransferPayload.from_bytes, JPayload.from_bytes):
        with pytest.raises(ValueError, match="keys do not match"):
            parse(bad)
    with pytest.raises(ValueError, match="magic"):
        KVTransferPayload.from_bytes(_corrupt(b"GKV1" + data[4:8] + b'{"keys": []}'))
    good = KVTransferPayload.from_bytes(data)
    eng = _port().start()
    try:
        eng.adopt_kv(good)
        pool = eng.pool
        free_before = len(pool._free_blocks)
        assert all(pool.prefix.lookup(k) is not None for k in good.keys)
        # the transfer turns out poisoned: its keys leave the prefix cache
        # and their retired blocks return to the free list
        assert eng.quarantine_kv(good.keys) == good.num_blocks
        assert all(pool.prefix.lookup(k) is None for k in good.keys)
        assert len(pool._free_blocks) == free_before + good.num_blocks
        assert eng.quarantine_kv(good.keys) == 0  # idempotent
        tokens, cached = _serve(eng)
        assert tokens == fresh and cached == 0  # served by a local prefill
        m = eng.metrics()
        assert m["kv_transfer_failures"] == {"corrupt": 2}
        assert m["kv_transfer_blocks"]["adopted"] == good.num_blocks
    finally:
        eng.stop()


def test_adopt_refuses_a_mismatched_payload_before_writing():
    data, _ = _exported(_port, False)
    payload = KVTransferPayload.from_bytes(data)
    eng = _port(kv_quant=True)
    with pytest.raises(ValueError, match="quantization mismatch"):
        eng.adopt_kv(payload)
    with pytest.raises(ValueError, match="fp/int8 mismatch"):
        eng.pool.adopt_blocks(payload.keys, payload.blocks)
    assert eng.pool.prefix.cached_blocks == 0
    with pytest.raises(ValueError, match="block_size"):
        BatchEngine(PARAMS, ARGS, TOK, EngineConfig(
            num_slots=2, max_len=128, prefill_chunk=16, block_size=32)).adopt_kv(payload)
    with pytest.raises(ValueError, match="prefix_cache"):
        _port(prefix_cache=False).export_kv(_ids())


def test_export_pins_blocks_until_released_once():
    eng = _port().start()
    try:
        _serve(eng)
        pool = eng.pool
        export = eng.call_in_loop(lambda: pool.export_blocks(_ids()))
        assert len(export.blocks) == len(_ids()) // BLOCK
        assert all(pool._ref[b] == 1 for b in export.blocks)  # pinned while retired
        eng.call_in_loop(lambda: pool.release_export(export))
        assert all(pool._ref[b] == 0 for b in export.blocks)
        with pytest.raises(ValueError, match="already released"):
            pool.release_export(export)
        # a prompt shorter than one block exports nothing
        assert eng.export_kv(_ids()[:BLOCK - 1]).num_blocks == 0
        assert eng.metrics()["kv_transfer_blocks"]["exported"] == 0
    finally:
        eng.stop()


# -- the fault registry ---------------------------------------------------------------
@pytest.mark.parametrize("trigger", [{}, {"nth": 3}, {"every": 2}, {"rate": 0.3, "seed": 7},
                                     {"every": 1, "times": 2}, {"match": "b"}])
def test_fault_rules_fire_on_the_same_calls_as_jax(trigger):
    labels = ["a", "b", "ab", "c", "b", "bb", "a", "b"] * 3
    fired = []
    for mod in (faults, jfaults):
        mod.reset()
        try:
            rule = mod.inject("kv_transfer.corrupt", **trigger)
            fired.append([mod.take("kv_transfer.corrupt", lab) is not None for lab in labels])
            assert mod.take("engine.swap_fail") is None
            assert mod.counts() == ({"kv_transfer.corrupt": rule.fires} if rule.fires else {})
        finally:
            mod.reset()
    assert fired[0] == fired[1] and any(fired[0])


def test_fault_points_and_urlopen_choke():
    import urllib.error

    assert faults.POINTS == jfaults.POINTS
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.inject("disk.full")
    with pytest.raises(ValueError, match="one trigger"):
        faults.Rule("arena.exhaust", nth=1, every=2)
    faults.reset()
    try:
        with faults.active("http.connect_refused", match="localhost:1/") as rule:
            with pytest.raises(urllib.error.URLError):
                faults.urlopen("http://localhost:1/healthz", timeout=1)
        assert rule.fires == 1 and faults.counts() == {"http.connect_refused": 1}
        assert faults._rules == []
    finally:
        faults.reset()
