"""The port's streaming data against the JAX package's, on the CPU.

The same seeded documents go through both packages' sources and
``StreamingDataManager``: local JSONL shards (shuffle buffer kept), a
WebDataset tar shard, synthetic documents and the hub stream through a fake
``datasets`` dataset (``ds_factory``, shuffle buffer 1). Batches and the
checkpoint snapshot after each must be equal, resume must continue the
stream exactly (in the port, and across the packages both ways), and the
elastic remaps must give JAX's states. Then the trainers: five steps of
each source give JAX's losses within 1e-5 relative (the port starts from
JAX's initial weights), prefetch on gives prefetch off's losses, and a
streaming run checkpointed at step 3 by one package resumes in the other
with steps 4-6 equal to the uninterrupted run.
"""

import json
import os
import tarfile

import jax
import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.config import DataConfig as JDataConfig
from mlx_cuda_distributed_pretraining_tpu.data import streaming as js
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig as TDataConfig
from mlx_cuda_distributed_pretraining_tpu_torch.convert import params_from_jax
from mlx_cuda_distributed_pretraining_tpu_torch.data import streaming as ts
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer, load_into

PKG = {"jax": (js, JDataConfig, JTok), "port": (ts, TDataConfig, TTok)}


# -- corpora ---------------------------------------------------------------------
def write_jsonl(path, n_docs, prefix="doc", seed=0):
    rng = np.random.default_rng(seed)
    words = ["ka", "lomi", "ne", "suta", "ripo", "an", "elor", "ve", "ü☃"]
    with open(path, "w") as f:
        for i in range(n_docs):
            text = f"{prefix} {i} " + " ".join(rng.choice(words, size=int(rng.integers(5, 40))))
            f.write(json.dumps({"text": text}) + "\n")
        f.write("not json\n\n" + json.dumps("a raw string document") + "\n")
    return str(path)


def write_tar(path, n_docs, seed=1):
    """A WebDataset shard: ``.txt`` and ``.json`` members, plus members the
    loader skips (another extension, an empty text, a JSON without text)."""
    import io

    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))

        for i in range(n_docs):
            body = f"tar doc {i} " + "lorem ipsum " * int(rng.integers(2, 20))
            if i % 3 == 0:
                add(f"{i:05d}.json", json.dumps({"text": body, "id": i}).encode())
            else:
                add(f"{i:05d}.txt", body.encode())
            if i % 7 == 0:
                add(f"{i:05d}.cls", b"3")
        add("empty.txt", b"")
        add("notext.json", json.dumps({"id": 1}).encode())
    return str(path)


class FakeHubDS:
    """A hub IterableDataset with the ``datasets`` state API."""

    def __init__(self, n=4000):
        self.pos, self.n = 0, n

    def __iter__(self):
        while self.pos < self.n:
            i = self.pos
            self.pos += 1
            yield {"text": f"hubdoc {i} " + "lorem ipsum " * (5 + i % 13)}

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = int(state["pos"])


class PlainHubDS:
    """A hub dataset without the state API: resume replays and skips."""

    def __iter__(self):
        for i in range(4000):
            yield {"text": f"plaindoc {i} " + "alpha beta " * (5 + i % 7)}


def source_data(tmp_path, source):
    """The ``data`` section of each source at context 32."""
    base = {"preprocessing": {"max_context_size": 32}, "tokenizer": {"normal_vocab_size": 256}}
    if source == "jsonl":
        shards = [write_jsonl(tmp_path / f"s{i}.jsonl", 30, f"shard{i}", seed=i)
                  for i in range(3)]
        return {**base, "source": "jsonl",
                "streaming": {"shards": shards, "shuffle_buffer": 8}}
    if source == "webdataset":
        shards = [write_tar(tmp_path / "t0.tar", 40),
                  write_jsonl(tmp_path / "s0.jsonl", 20, "json")]
        return {**base, "source": "webdataset", "streaming": {"shards": shards}}
    if source == "synthetic":
        return {**base, "source": "synthetic", "streaming": {"shuffle_buffer": 8}}
    if source == "hf_stream":
        return {**base, "source": "hf_stream",
                "streaming": {"ds_factory": FakeHubDS, "shuffle_buffer": 1}}
    raise ValueError(source)


def manager(pkg, data, batch_size=2, seq_len=32, **kw):
    mod, dc, tok = PKG[pkg]
    cfg = dc(**data)
    return mod.StreamingDataManager(cfg, tok(cfg), batch_size=batch_size, seq_len=seq_len,
                                    **kw)


def take_batches(mgr, n):
    out = []
    try:
        for i in range(n):
            out.append((mgr.generate_batch(i), mgr.state_dict()))
    finally:
        mgr.stop()
    return out


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gb, gs), (wb, ws) in zip(got, want):
        for k in wb:
            assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape
            np.testing.assert_array_equal(gb[k], wb[k])
        assert gs == ws
        json.dumps(gs)  # the snapshot is a checkpoint's JSON


# -- sources -------------------------------------------------------------------
def test_text_sources_and_filters_equal_jax(tmp_path):
    p = write_jsonl(tmp_path / "a.jsonl", 12)
    take = lambda it, n: [x for _, x in zip(range(n), it)]  # noqa: E731
    assert list(ts.iter_jsonl_shards([p], repeat=False)) == list(
        js.iter_jsonl_shards([p], repeat=False))
    assert take(ts.iter_jsonl_shards([p]), 40) == take(js.iter_jsonl_shards([p]), 40)
    assert take(ts.iter_synthetic(seed=3, vocab=50), 20) == take(
        js.iter_synthetic(seed=3, vocab=50), 20)
    items = [str(i) for i in range(100)]
    for buffer_size in (0, 1, 16, 200):
        assert list(ts.shuffled(iter(items), buffer_size, 7)) == list(
            js.shuffled(iter(items), buffer_size, 7))
    for index in range(3):
        assert list(ts.sharded(iter(items), index, 3)) == list(js.sharded(iter(items), index, 3))


@pytest.mark.parametrize("kind", ["jsonl", "tar"])
def test_load_shard_docs_equals_jax(tmp_path, kind):
    path = (write_jsonl(tmp_path / "a.jsonl", 25) if kind == "jsonl"
            else write_tar(tmp_path / "a.tar", 25))
    docs = ts.load_shard_docs(path)
    assert docs == js.load_shard_docs(path) and len(docs) >= 25


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("repeat", [True, False])
def test_seekable_source_order_and_state_equal_jax(tmp_path, process_index,
                                                   process_count, repeat):
    shards = [write_jsonl(tmp_path / f"s{i}.jsonl", 10 + 3 * i, f"s{i}") for i in range(3)]
    shards.append(write_tar(tmp_path / "t.tar", 12))
    kw = dict(seed=7, repeat=repeat, process_index=process_index,
              process_count=process_count)
    t, j = ts.SeekableShuffledSource(shards, **kw), js.SeekableShuffledSource(shards, **kw)
    ti, ji = iter(t), iter(j)
    for _ in range(150 // process_count):
        a, b = next(ti, None), next(ji, None)
        assert a == b
        assert t.state_dict() == j.state_dict()
        if a is None:
            break
    # resumed from a mid-stream snapshot, each package's source goes on as
    # the uninterrupted one did
    j = js.SeekableShuffledSource(shards, **kw)
    ji = iter(j)
    head = [x for _, x in zip(range(9), ji)]
    state = j.state_dict()
    rest = [x for _, x in zip(range(20), ji)]
    for mod in (ts, js):
        resumed = mod.SeekableShuffledSource(shards, **kw)
        resumed.load_state_dict(state)
        assert [x for _, x in zip(range(20), resumed)] == rest
    assert len(head) == 9


def test_seekable_source_refuses_another_world_as_jax(tmp_path):
    shards = [write_jsonl(tmp_path / "s.jsonl", 10)]
    state = ts.SeekableShuffledSource(shards, process_count=2).state_dict()
    for mod in (ts, js):
        with pytest.raises(ValueError, match="world mismatch"):
            mod.SeekableShuffledSource(shards, process_count=3).load_state_dict(state)
        with pytest.raises(ValueError, match="host mismatch"):
            mod.SeekableShuffledSource(shards, process_index=1,
                                       process_count=2).load_state_dict(state)


def test_disk_space_manager_removes_the_oldest_as_jax(tmp_path):
    for pkg, mod in (("jax", js), ("port", ts)):
        cache = tmp_path / pkg
        mgr = mod.DiskSpaceManager(str(cache), max_gb=2500 / (1 << 30))
        for i in range(5):
            p = cache / f"f{i}.bin"
            p.write_bytes(b"x" * 1000)
            os.utime(p, (1000 + i, 1000 + i))
        assert mgr.usage_bytes() == 5000
        mgr.ensure_space()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["f3.bin", "f4.bin"]


# -- the streaming manager ---------------------------------------------------------
@pytest.mark.parametrize("source", ["jsonl", "webdataset", "synthetic", "hf_stream"])
def test_streaming_batches_and_snapshots_equal_jax(tmp_path, source):
    data = source_data(tmp_path, source)
    want = take_batches(manager("jax", data), 8)
    got = take_batches(manager("port", data), 8)
    assert_same_batches(got, want)
    assert got[0][0]["inputs"].shape == (2, 32) and got[0][0]["inputs"].dtype == np.int32
    if source in ("jsonl", "webdataset"):
        assert "source" in got[-1][1] and isinstance(got[-1][1]["buf"], list)
    if source == "hf_stream":
        assert got[-1][1]["hf"]["pos"] > 0


@pytest.mark.parametrize("source", ["jsonl", "webdataset", "hf_stream"])
@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_streaming_resume_is_exact_across_packages(tmp_path, source, first, second):
    data = source_data(tmp_path, source)
    full = take_batches(manager("jax", data), 7)
    part = take_batches(manager(first, data), 3)
    state = json.loads(json.dumps(part[-1][1]))  # through a checkpoint's JSON
    resumed = {}
    for pkg in (second, "jax"):
        mgr = manager(pkg, data)
        mgr.load_state_dict(state)
        resumed[pkg] = take_batches(mgr, 4)
    # the uninterrupted run's batches; the snapshots JAX's resumed run takes
    # (a resumed packer reads a document before draining its leftover
    # tokens, so its positions may stand a document later for the same rows)
    for (got, _), (want, _) in zip(resumed[second], full[3:]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert_same_batches(resumed[second], resumed["jax"])


def test_hub_stream_without_the_state_api_skips_replayed_docs_as_jax(tmp_path):
    data = {"preprocessing": {"max_context_size": 32}, "source": "hf_stream",
            "streaming": {"ds_factory": PlainHubDS, "shuffle_buffer": 1}}
    want = take_batches(manager("jax", data), 3)
    assert "hf" not in want[-1][1]
    got = take_batches(manager("port", data), 3)
    assert_same_batches(got, want)
    resumed = {}
    for pkg in ("jax", "port"):
        mgr = manager(pkg, data)
        mgr.load_state_dict(want[-1][1])
        resumed[pkg] = take_batches(mgr, 2)
    assert_same_batches(resumed["port"], resumed["jax"])


def test_finite_stream_and_producer_errors_end_as_in_jax(tmp_path):
    p = write_jsonl(tmp_path / "s.jsonl", 3)
    data = {"preprocessing": {"max_context_size": 32},
            "streaming": {"shards": [p], "repeat": False, "shuffle_buffer": 1}}
    served = {}
    for pkg in ("jax", "port"):
        mgr = manager(pkg, data)
        n = 0
        with pytest.raises(StopIteration):
            while True:
                mgr.generate_batch(n)
                n += 1
        mgr.stop()
        served[pkg] = n
    assert served["port"] == served["jax"] > 0
    bad = {"preprocessing": {"max_context_size": 32},
           "streaming": {"shards": [str(tmp_path / "missing.jsonl")]}}
    for pkg in ("jax", "port"):
        mgr = manager(pkg, bad)
        with pytest.raises(RuntimeError, match="streaming producer failed"):
            mgr.generate_batch(0)
        mgr.stop()


def test_build_data_manager_dispatches_as_jax(tmp_path):
    cases = [source_data(tmp_path, s) for s in ("jsonl", "webdataset", "synthetic",
                                                "hf_stream")]
    train = write_jsonl(tmp_path / "train.jsonl", 40)
    cases.append({"input_file": train, "preprocessing": {"max_context_size": 32}})
    cases.append({"input_file": train, "preprocessing": {"max_context_size": 32},
                  "streaming": {"enabled": True}})
    for data in cases:
        got = {}
        for pkg in ("jax", "port"):
            mod, dc, tok = PKG[pkg]
            cfg = dc(**data)
            mgr = mod.build_data_manager(cfg, tok(cfg), batch_size=2, seq_len=32)
            got[pkg] = type(mgr).__name__
            if hasattr(mgr, "stop"):
                mgr.stop()
        assert got["port"] == got["jax"], data


@pytest.mark.parametrize("old,new", [(2, 3), (4, 1), (3, 2)])
def test_remap_data_states_equal_jax(tmp_path, old, new):
    data = source_data(tmp_path, "jsonl")
    states = []
    for index in range(old):
        mgr = manager("port", data, process_index=index, process_count=old)
        states.append(take_batches(mgr, 2 + index)[-1][1])
    for index in range(new):
        got = ts.remap_data_states(states, index, new)
        assert got == js.remap_data_states(states, index, new)
        assert got["process_count"] == new and got["process_index"] == index
        assert ts.remap_seekable_states([s["source"] for s in states], index, new) == \
            js.remap_seekable_states([s["source"] for s in states], index, new)
    # the remapped hosts of the new world read the rest of the stream disjointly
    docs = []
    for index in range(new):
        src = ts.SeekableShuffledSource(ts.StreamingDataManager(
            TDataConfig(**data), TTok(TDataConfig(**data)), 2)._expand_shards(),
            seed=42, process_index=index, process_count=new)
        src.load_state_dict(ts.remap_data_states(states, index, new)["source"])
        docs.append([d for _, d in zip(range(15), src)])
    assert all(not set(docs[a]) & set(docs[b])
               for a in range(new) for b in range(a + 1, new))


def test_remap_refusals_equal_jax(tmp_path):
    hf = take_batches(manager("port", source_data(tmp_path, "hf_stream")), 1)[-1][1]
    hf2 = [dict(hf, process_index=i, process_count=2) for i in range(2)]
    cases = [(hf2, 0, 1), ([dict(hf, process_count=2)], 0, 1),
             ([{"docs_consumed": 1}], 0, 2)]
    for states, index, count in cases:
        msgs = []
        for mod in (js, ts):
            with pytest.raises(ValueError) as err:
                mod.remap_data_states(states, index, count)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# -- the trainers ------------------------------------------------------------------
def trainer_config(data, name, iters=5, ckpt=0, prefetch_depth=2):
    return {"name": name, "overwrite": True,
            "data": {**data, "prefetch_depth": prefetch_depth},
            "model": {"architecture": "llama",
                      "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                     "num_layers": 2},
                      "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
            "training": {"hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                             "iters": iters},
                         "optimization": {"optimizer": "adamw"},
                         "scheduler": {"type": "cosine", "min_lr_ratio": 0.1}},
            "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": ckpt,
                                  "validation_interval": 0}},
            "system": {"seed": 0}}


def capture_losses(trainer):
    """Full-precision losses of each log line (log.txt rounds them)."""
    out = {}
    real = trainer.logger.log_metrics

    def log_metrics(step, line):
        out[step] = float(line["loss"])
        real(step, line)

    trainer.logger.log_metrics = log_metrics
    return out


def jax_trainer(d, runs):
    return JTrainer(JConfig.from_dict(d), runs_root=runs, quiet=True)


def initial_weights(jtr):
    """A JAX trainer's weights (before its train(): its initial ones)."""
    return jax.tree_util.tree_map(np.asarray, jtr.state["params"])


def port_trainer(d, runs, init=None):
    """The port's trainer; with ``init`` (:func:`initial_weights`) it starts
    from a JAX trainer's weights (the two packages' seeded inits differ)."""
    tr = Trainer(TConfig.from_dict(d), runs_root=runs, quiet=True, device="cpu")
    if init is not None:
        load_into(tr.state["params"], params_from_jax(init, "cpu"))
    return tr


def assert_same_losses(got, want, steps):
    assert sorted(got) == list(steps)
    for s in steps:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5, err_msg=f"step {s}")


@pytest.fixture
def hub(monkeypatch):
    """``datasets.load_dataset`` answering with the fake hub dataset: both
    packages' default ``ds_factory`` (a callable in the config cannot be
    written to config.yaml by either trainer)."""
    import datasets

    calls = []

    def load_dataset(path, **kw):
        calls.append((path, kw))
        return FakeHubDS()

    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    return calls


def trainer_data(tmp_path, source):
    data = source_data(tmp_path, source)
    if source == "hf_stream":
        data["streaming"] = {"dataset": "fake/fineweb", "shuffle_buffer": 1}
    return data


@pytest.mark.parametrize("source", ["jsonl", "webdataset", "synthetic", "hf_stream"])
def test_streaming_trainer_losses_equal_jax_and_prefetch_off(tmp_path, hub, source):
    data = trainer_data(tmp_path, source)
    jtr = jax_trainer(trainer_config(data, "j"), str(tmp_path / "j"))
    init = initial_weights(jtr)
    want = capture_losses(jtr)
    jtr.train()
    got = {}
    for depth in (2, 0):
        tr = port_trainer(trainer_config(data, f"t{depth}", prefetch_depth=depth),
                          str(tmp_path / f"t{depth}"), init=init)
        assert tr.total_steps == 5
        got[depth] = capture_losses(tr)
        tr.train()
        assert tr.prefetcher.depth == depth
        assert all("data_wait_s" in w and "h2d_wait_s" in w for w in tr.windows)
    assert_same_losses(got[2], want, range(1, 6))
    assert got[0] == got[2]  # prefetch on and off: the same batches, bitwise
    if source == "hf_stream":
        assert hub and hub[0][0] == "fake/fineweb" and hub[0][1]["streaming"] is True


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("source", ["jsonl", "hf_stream"])
def test_streaming_run_resumes_across_packages(tmp_path, hub, source, first):
    """One package trains 6 steps uninterrupted (prefetch 2, a checkpoint at
    3); the other resumes from step 3, and its steps 4-6 give the first's
    losses. The saved position is the consumed one: the queue held more."""
    data = trainer_data(tmp_path, source)
    runs = str(tmp_path / "runs")
    d = trainer_config(data, "resume", iters=6, ckpt=3)
    tr1 = jax_trainer(d, runs) if first == "jax" else port_trainer(d, runs)
    want = capture_losses(tr1)
    tr1.train()
    with open(os.path.join(tr1.run_dir, "checkpoints", "step_3_state.json")) as f:
        state = json.load(f)
    assert {"docs_consumed", "buf", "process_count", "process_index"} <= set(state)
    assert ("hf" if source == "hf_stream" else "source") in state
    d2 = dict(d, overwrite=False, resume={"checkpoint": "3"})
    tr2 = port_trainer(d2, runs) if first == "jax" else jax_trainer(d2, runs)
    assert tr2.start_step == 3
    got = capture_losses(tr2)
    tr2.train()
    assert_same_losses(got, want, [4, 5, 6])


def test_port_resume_of_its_own_streaming_run_is_exact(tmp_path):
    data = trainer_data(tmp_path, "webdataset")
    runs = str(tmp_path / "runs")
    d = trainer_config(data, "own", iters=6, ckpt=3)
    tr = port_trainer(d, runs)
    want = capture_losses(tr)
    tr.train()
    tr2 = port_trainer(dict(d, overwrite=False, resume={"checkpoint": "3"}), runs)
    got = capture_losses(tr2)
    tr2.train()
    assert got == {s: want[s] for s in (4, 5, 6)}  # bitwise on the CPU


def test_streaming_trainer_needs_iters_and_stops_when_the_stream_ends(tmp_path):
    p = write_jsonl(tmp_path / "s.jsonl", 6)
    data = {"preprocessing": {"max_context_size": 32},
            "streaming": {"shards": [p], "repeat": False, "shuffle_buffer": 1}}
    d = trainer_config(data, "dry", iters=100)
    d["training"]["hyperparameters"].pop("iters")
    for make in (lambda: jax_trainer(d, str(tmp_path / "j0")),
                 lambda: port_trainer(d, str(tmp_path / "t0"))):
        with pytest.raises(ValueError, match="require training.iters"):
            make()
    d = trainer_config(data, "dry", iters=100)
    logs = {}
    for pkg, make in (("jax", lambda: jax_trainer(d, str(tmp_path / "j1"))),
                      ("port", lambda: port_trainer(d, str(tmp_path / "t1")))):
        tr = make()
        result = tr.train()
        with open(os.path.join(tr.run_dir, "log.txt")) as f:
            logs[pkg] = [line.strip().split("] ", 1)[-1] for line in f
                         if "exhausted" in line]
        assert result["steps"] < 100
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 1
    assert logs["port"][0].startswith("Data stream exhausted before step ")


def test_a_checkpoint_with_per_host_data_sidecars_is_refused(tmp_path):
    """A run of several processes writes each host's data position beside
    the checkpoint, and a resume reads them (across world sizes too:
    tests/test_torch_dist_ckpt.py). Sidecars that claim a world of two
    around positions taken in a world of one are refused, with the error
    the JAX trainer raises on the same files."""
    data = trainer_data(tmp_path, "jsonl")
    runs = str(tmp_path / "runs")
    d = trainer_config(data, "sidecars", iters=3, ckpt=3)
    tr = port_trainer(d, runs)
    tr.train()
    with open(tr.checkpoints.paths_for_step(3)[2]) as f:
        state = json.load(f)
    for index in range(2):
        with open(os.path.join(tr.run_dir, "checkpoints", f"step_3_data_p{index}.json"),
                  "w") as f:
            json.dump(dict(state, process_count=2, process_index=index), f)
    for make in (port_trainer, jax_trainer):
        with pytest.raises(ValueError, match="disagree with the set size"):
            make(dict(d, overwrite=False, resume={"checkpoint": "3"}), runs)
