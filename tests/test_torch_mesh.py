"""The port's mesh, partition rules, shard layout, per-rank data and
rendezvous against the JAX package's, on the CPU (no process group: the
rules are pure functions of paths, shapes and axis sizes).

- ``mesh_axis_sizes`` equals JAX's, its errors and "STRANDED" warning
  included, on 1, 2, 4 and 8 devices, for the legacy ``model_parallel``
  flags too.
- ``param_pspec`` / ``state_sharding`` (ZeRO 0 and 1) equal JAX's spec for
  every leaf of the dense, the MoE and an int8-quantized tree, and of their
  AdamW, Adafactor and Shampoo states, on {dp: 4}, {fsdp: 4}, {dp: 2,
  fsdp: 2} and {dp: 2, tp: 2}; a rank's block of a tensor is the shard JAX
  puts on the device of the same index; the fsdp gather's buckets equal
  JAX's.
- The in-memory loader, the streaming manager and the token shards at
  ``(index i, count N)``, N in 1-4, yield JAX's rows for every i; the
  prefetcher over a mesh is bitwise equal to prefetch off.
- An explicit coordinator that never answers raises ``RendezvousError``
  within its deadline; tp, ep, sp and pp above 1 are refused, each naming
  its ROADMAP item.
"""

import socket
import time
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig as JDataConfig
from mlx_cuda_distributed_pretraining_tpu.data.memory import DataManager as JData
from mlx_cuda_distributed_pretraining_tpu.data.token_shards import TokenShardDataManager as JShards
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.models.quantize import quantize_weights
from mlx_cuda_distributed_pretraining_tpu.optim import factory as jfactory
from mlx_cuda_distributed_pretraining_tpu.parallel import mesh as jmesh
from mlx_cuda_distributed_pretraining_tpu.parallel import overlap as joverlap
from mlx_cuda_distributed_pretraining_tpu.parallel import sharding_rules as jrules
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig as TDataConfig
from mlx_cuda_distributed_pretraining_tpu_torch.data import DevicePrefetcher
from mlx_cuda_distributed_pretraining_tpu_torch.data.memory import DataManager as TData
from mlx_cuda_distributed_pretraining_tpu_torch.data.token_shards import (
    TokenShardDataManager as TShards,
)
from mlx_cuda_distributed_pretraining_tpu_torch.optim import factory as tfactory
from mlx_cuda_distributed_pretraining_tpu_torch.parallel import collectives, elastic
from mlx_cuda_distributed_pretraining_tpu_torch.parallel import mesh as tmesh
from mlx_cuda_distributed_pretraining_tpu_torch.parallel import overlap as toverlap
from mlx_cuda_distributed_pretraining_tpu_torch.parallel import sharding_rules as trules
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import resolve_mesh
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import tree_map
from test_torch_optimizers import Cfg
from test_torch_streaming import assert_same_batches, manager, take_batches, write_jsonl
from test_torch_token_shards import _docs

SPECS = [{"dp": -1}, {"fsdp": -1}, {"dp": 2, "fsdp": -1}, {"dp": -1, "fsdp": 4},
         {"pp": 4, "dp": -1}, {"tp": 2}, {}, {"xx": 2}]
LEGACY = [dict(model_parallel=True, model_parallel_size=2),
          dict(model_parallel=True, model_parallel_size=1), dict(model_parallel=False)]
MESHES = [{"dp": 4}, {"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2}]


def _outcome(fn, cfg, n):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            result = ("ok", fn(cfg, n))
        except ValueError as e:
            result = ("error", str(e))
    return result, [str(w.message) for w in caught]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_axis_sizes_equal_jax(n):
    for cfg in [SimpleNamespace(mesh=m) for m in SPECS] + [
            SimpleNamespace(mesh={}, **flags) for flags in LEGACY]:
        j = _outcome(jmesh.mesh_axis_sizes, cfg, n)
        t = _outcome(tmesh.mesh_axis_sizes, cfg, n)
        assert t == j, (cfg, n)
        if j[0][0] == "ok":
            assert list(t[0][1]) == list(j[0][1])  # the axis order too
            assert tmesh.mesh_device_count(t[0][1]) == jmesh.mesh_device_count(j[0][1])


def test_mesh_spec_parsing_and_serve_mesh_equal_jax():
    for spec in ("tp=2", "tp=2,dp=1", " dp = 4 ,", "tp", "tp=x"):
        try:
            j = jmesh.parse_mesh_spec(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                tmesh.parse_mesh_spec(spec)
            continue
        assert tmesh.parse_mesh_spec(spec) == j
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER and tmesh.SERVE_AXES == jmesh.SERVE_AXES
    assert tmesh.build_serve_mesh(None) is None and tmesh.build_serve_mesh("tp=1,dp=1") is None
    with pytest.raises(ValueError, match="trainer-only"):
        tmesh.build_serve_mesh({"fsdp": 2})
    with pytest.raises(ValueError, match="parallel.launch"):  # a world of one rank
        tmesh.build_serve_mesh("tp=2")


def _jax_mesh(sizes):
    return jmesh.build_mesh(SimpleNamespace(mesh=sizes),
                            jax.devices()[:int(np.prod(list(sizes.values())))])


def _trees():
    dense = jl.LlamaArgs(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=8, attention_bias=True,
                         tie_word_embeddings=False)
    moe = jl.LlamaArgs(vocab_size=259, hidden_size=32, intermediate_size=64, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=8, num_local_experts=4,
                       num_experts_per_tok=2)
    dp = jl.init_params(jax.random.PRNGKey(0), dense)
    mp = jl.init_params(jax.random.PRNGKey(1), moe)
    return {"dense": dp, "moe": mp, "int8": quantize_weights(dp, "int8"),
            "moe_int8": quantize_weights(mp, "int8")}


def _flat_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {jrules._path_str(p): tuple(s.spec) for p, s in leaves}


def _port_specs(tree):
    return {".".join(p): tuple(s) for p, s in trules.spec_items(tree) if s is not None}


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "_".join(f"{k}{v}" for k, v in m.items()))
def test_param_and_state_specs_equal_jax(sizes):
    jm, tm = _jax_mesh(sizes), tmesh.abstract_mesh(sizes)
    for name, params in _trees().items():
        like = tree_map(lambda x: torch.empty(x.shape, device="meta"),
                        jax.tree_util.tree_map(np.asarray, params))
        jspecs = jrules.tree_pspecs(params, jm)
        tspecs = trules.tree_pspecs(like, tm)
        flat_j = {jrules._path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        assert _port_specs(tspecs) == flat_j, name
        optimizers = (["adamw", "adafactor", "shampoo"] if not name.endswith("int8") else [])
        for opt_name in optimizers:
            cfg = Cfg({"optimizer": opt_name, "max_preconditioner_dim": 40})
            jstate = {"params": params, "opt_state": jfactory.build_optimizer(cfg, 10).init(params),
                      "step": 0}
            tstate = {"params": like, "opt_state": tfactory.build_optimizer(cfg, 10).init(like),
                      "step": 0}
            for zero in (0, 1):
                j = jrules.state_sharding(jstate, jm, zero)
                t = trules.state_sharding(tstate, tm, zero)
                assert _port_specs(t["params"]) == _flat_specs(j["params"])
                assert _port_specs(t["opt_state"]) == _flat_specs(j["opt_state"]), (
                    name, opt_name, zero)
    assert tuple(trules.batch_pspec(tm)) == tuple(jrules.batch_pspec(jm))
    assert {k: tuple(v) if isinstance(v, tuple) else v
            for k, v in trules.moe_dispatch_specs(tm).items()} == {
        k: tuple(v) if isinstance(v, tuple) else v
        for k, v in jrules.moe_dispatch_specs(jm).items()}


def test_no_shape_collision_between_wq_and_wo():
    """``test_distributed.py::test_sharding_no_shape_collision`` on the port:
    wq and wo of one shape keep their transposed specs, and so do their
    optimizer moments (matched by path, not shape)."""
    tm = tmesh.abstract_mesh({"fsdp": 2, "tp": 2})
    like = {"layers": [{"attention": {"wq": {"weight": torch.empty(8, 8, device="meta")},
                                      "wo": {"weight": torch.empty(8, 8, device="meta")}}}]}
    opt = tfactory.build_optimizer(Cfg({"optimizer": "adamw"}), 10)
    specs = trules.state_sharding({"params": like, "opt_state": opt.init(like), "step": 0}, tm)
    flat = _port_specs(specs["opt_state"])
    assert flat["1.mu.layers.0.attention.wq.weight"] == ("fsdp", "tp")
    assert flat["1.mu.layers.0.attention.wo.weight"] == ("tp", "fsdp")


@pytest.mark.parametrize("sizes", [{"dp": 2, "fsdp": 2}, {"fsdp": 4}, {"dp": 4}])
def test_a_ranks_block_is_the_jax_shard_of_its_device(sizes):
    jm = _jax_mesh(sizes)
    full = np.arange(8 * 12 * 3, dtype=np.float32).reshape(8, 12, 3)
    for spec in [("fsdp", None, None), (None, "dp", None), (("dp", "fsdp"), None, None),
                 (None, "fsdp", None), ("dp", "fsdp", None)]:
        spec = tuple(a if a is None or isinstance(a, tuple) or a in sizes else None
                     for a in spec)
        spec = tuple(tuple(x for x in a if x in sizes) or None if isinstance(a, tuple) else a
                     for a in spec)
        arr = jax.device_put(full, NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))
        by_device = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        for rank, dev in enumerate(jm.devices.flat):
            block = collectives.shard_of(torch.from_numpy(full), trules.P(*spec),
                                         tmesh.abstract_mesh(sizes, rank=rank))
            np.testing.assert_array_equal(block.numpy(), by_device[dev.id], err_msg=str(spec))


@pytest.mark.parametrize("sizes", [{"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"dp": 4}])
def test_gather_buckets_and_the_overlap_gate_equal_jax(sizes):
    jm, tm = _jax_mesh(sizes), tmesh.abstract_mesh(sizes)
    params = _trees()["dense"]
    jlayer = params["layers"][0]
    tlayer = tree_map(lambda x: torch.empty(x.shape, device="meta"),
                      jax.tree_util.tree_map(np.asarray, jlayer))
    jdims = jax.tree_util.tree_leaves(joverlap.layer_gather_dims(jlayer, jm),
                                      is_leaf=lambda v: v is None)
    tdims = toverlap.layer_gather_dims(tlayer, tm)
    assert tdims == jdims
    n = sizes.get("fsdp", 1)
    if n > 1:
        for bucket_bytes in (joverlap.DEFAULT_BUCKET_BYTES, 4096):
            jb = joverlap.bucket_layout(jax.tree_util.tree_leaves(jlayer), jdims, n, bucket_bytes)
            tb = toverlap.bucket_layout(
                [x for _, x in toverlap._leaves(tlayer)], tdims, n, bucket_bytes)
            assert [(b.entries, b.shard_elems) for b in tb] == [
                (b.entries, b.shard_elems) for b in jb]
    tlayers = [tlayer, tlayer]
    for batch in (8, 6):
        assert toverlap.can_overlap(tm, tlayers, batch) == joverlap.can_overlap(
            jm, [jlayer, jlayer], batch)
    assert toverlap.can_overlap(None, tlayers, 8) is joverlap.can_overlap(None, [jlayer], 8)


# -- per-rank data ------------------------------------------------------------------------
def _corpus(tmp_path, n=40):
    import json

    path = tmp_path / "c.jsonl"
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"text": f"doc {i} " + "alpha beta gamma " * (1 + i % 7)}) + "\n")
    return str(path)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_in_memory_loader_rows_per_rank_equal_jax(tmp_path, count):
    path = _corpus(tmp_path)
    data = dict(input_file=path, validation_file=path,
                preprocessing={"max_context_size": 16}, tokenizer={"normal_vocab_size": 256})
    jc, tc = JDataConfig(**data), TDataConfig(**data)
    for i in range(count):
        j = JData(jc, JTok(jc), 2, seq_len=16, seed=3, process_index=i, process_count=count)
        t = TData(tc, TTok(tc), 2, seq_len=16, seed=3, process_index=i, process_count=count)
        np.testing.assert_array_equal(t.train_rows, j.train_rows)
        np.testing.assert_array_equal(t.val_rows, j.val_rows)
        assert t.batches_per_epoch == j.batches_per_epoch
        for step in (0, 1, t.batches_per_epoch, 2 * t.batches_per_epoch + 1):
            for k, v in j.generate_batch(step).items():
                np.testing.assert_array_equal(t.generate_batch(step)[k], v)
        assert [b["inputs"].tolist() for b in t.iter_validation(3)] == [
            b["inputs"].tolist() for b in j.iter_validation(3)]


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_streaming_and_token_shards_per_rank_equal_jax(tmp_path, count):
    shards = [write_jsonl(tmp_path / f"s{i}.jsonl", 24, f"shard{i}", seed=i) for i in range(2)]
    data = {"preprocessing": {"max_context_size": 32}, "tokenizer": {"normal_vocab_size": 256},
            "source": "jsonl", "streaming": {"shards": shards, "shuffle_buffer": 4}}
    from mlx_cuda_distributed_pretraining_tpu_torch.data.token_shards import (
        write_token_shards as t_write,
    )

    t_write(iter(_docs(200)), TTok(TDataConfig()), str(tmp_path / "tok"), shard_tokens=2000)
    for i in range(count):
        kw = dict(process_index=i, process_count=count, seed=5)
        assert_same_batches(take_batches(manager("port", data, **kw), 3),
                            take_batches(manager("jax", data, **kw), 3))
        skw = dict(batch_size=2, seq_len=31, seed=5, process_index=i, process_count=count,
                   val_fraction=0.05)
        js, tsh = JShards(str(tmp_path / "tok"), **skw), TShards(str(tmp_path / "tok"), **skw)
        for step in range(4):
            for k, v in js.generate_batch(step).items():
                np.testing.assert_array_equal(tsh.generate_batch(step)[k], v)


def test_prefetcher_over_a_mesh_equals_prefetch_off(tmp_path):
    path = _corpus(tmp_path)
    tc = TDataConfig(input_file=path, preprocessing={"max_context_size": 16},
                     tokenizer={"normal_vocab_size": 256})
    mesh = tmesh.abstract_mesh({"dp": 2, "fsdp": 2}, rank=3)

    def loader():
        return TData(tc, TTok(tc), 2, seq_len=16, seed=3, process_index=3, process_count=4)

    on = DevicePrefetcher(loader(), mesh=mesh, depth=2, total_steps=6)
    off = DevicePrefetcher(loader(), depth=0, total_steps=6)
    try:
        for _ in range(6):
            a, ta, _ = on.get()
            b, tb, _ = off.get()
            assert ta == tb
            for k in b:
                assert a[k].dtype == b[k].dtype
                assert torch.equal(a[k], b[k])
        assert on.state_dict() == off.state_dict() == {
            "val_ptr": 0, "process_count": 4, "process_index": 3}
    finally:
        on.stop()
        off.stop()


# -- rendezvous and refusals ----------------------------------------------------------------
def test_a_coordinator_that_never_answers_raises_within_its_deadline():
    with socket.socket() as silent:  # listens, never accepts or speaks
        silent.bind(("127.0.0.1", 0))
        silent.listen(0)
        coord = f"127.0.0.1:{silent.getsockname()[1]}"
        logs = []
        t0 = time.monotonic()
        with pytest.raises(elastic.RendezvousError, match="could not rendezvous"):
            elastic.rendezvous(coord, 2, 1, backend="gloo", timeout_s=3.0,
                               attempt_timeout_s=1.0, backoff_base=0.2, log=logs.append)
        elapsed = time.monotonic() - t0
    assert elapsed < 3.0 + 5.0, elapsed
    assert len([m for m in logs if "attempt" in m]) >= 2, logs
    # with no coordinator anywhere the run is single-process (no group)
    assert elastic.rendezvous(None, None, None, log=logs.append) is False
    assert elastic.process_barrier("nothing") is True


@pytest.mark.parametrize("axis,item", [("tp", "10a"), ("ep", "10b"), ("sp", "10c"),
                                       ("pp", "10d")])
def test_unported_axes_are_refused_naming_their_item(tmp_path, axis, item):
    cfg = SimpleNamespace(mesh={"dp": -1, axis: 2}, model_parallel=False)
    if axis == "tp":  # ported (item 10a): one rank lacks the mesh's ranks
        with pytest.raises(ValueError, match="needs 2 devices, have 1.*parallel.launch "
                                             "--nproc-per-node 2"):
            resolve_mesh(cfg, 8)
        tmesh.refuse_unported_axes({axis: 4})
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
            resolve_mesh(cfg, 8)
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
            tmesh.refuse_unported_axes({axis: 4})
    tmesh.refuse_unported_axes({"dp": 4, "fsdp": 2, axis: 1})  # size 1 is no axis
    # one rank, no mesh: the one-device path
    assert resolve_mesh(SimpleNamespace(mesh={}, model_parallel=False), 8) is None
    m = resolve_mesh(SimpleNamespace(mesh={"fsdp": -1}, model_parallel=False), 8)
    assert m.shape == {"fsdp": 1} and m.size == 1


def test_a_multi_process_run_needs_a_rendezvous(tmp_path):
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import main

    cfg = tmp_path / "c.json"
    cfg.write_text('{"name": "r"}')
    with pytest.raises(ValueError, match="needs a rendezvous"):
        main(["--config", str(cfg), "--device", "cpu", "--num-processes", "2"])
