"""The port's device prefetcher against the JAX package's, on the CPU.

Ordering, the depth's backpressure, StopIteration after a prefix, a loader
or copy error raised at ``get()``, stop and join, the synchronous mode
equal to the threaded one, and the checkpoint contract: ``state_dict()`` is
the position the trainer consumed, equal to JAX's prefetcher's and to a
plain loader's, and a resume from it continues the stream exactly. On the
CPU a batch is a view of the loader's arrays: nothing is pinned. (The
pinned side-stream copy is held on the card by the ``cuda`` tests in
``tests/test_torch_kernels_cuda.py``.)
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.data.device_prefetch import (
    DevicePrefetcher as JPrefetcher,
)
from mlx_cuda_distributed_pretraining_tpu_torch.data import DevicePrefetcher
from test_torch_streaming import (
    capture_losses,
    manager,
    port_trainer,
    source_data,
    trainer_config,
)


class FakeLoader:
    """Batches that encode their step; StopIteration past ``limit``."""

    def __init__(self, limit=10**9, fail_at=None):
        self.limit, self.fail_at, self.fetches = limit, fail_at, 0
        self.arrays = []

    def generate_batch(self, step):
        self.fetches += 1
        if step >= self.limit:
            raise StopIteration("dry")
        if step == self.fail_at:
            raise RuntimeError("producer died")
        batch = {"inputs": np.full((2, 4), step, np.int32),
                 "targets": np.full((2, 4), step + 1, np.int32),
                 "mask": np.ones((2, 4), np.float32)}
        self.arrays.append(batch)
        return batch

    def state_dict(self):
        return {"val_ptr": 0}

    def load_state_dict(self, state):
        pass


def drain(pf):
    out = []
    while True:
        try:
            batch, tokens, waits = pf.get()
        except StopIteration:
            return out
        out.append((int(np.asarray(batch["inputs"])[0, 0]), tokens, waits))


def wait_until(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("depth", [2, 0])
def test_order_tokens_and_waits_equal_jax(depth):
    got = drain(DevicePrefetcher(FakeLoader(), depth=depth, start_step=3, total_steps=9))
    jpf = JPrefetcher(FakeLoader(), depth=depth, start_step=3, total_steps=9)
    want = drain(jpf)
    jpf.stop()
    assert [g[:2] for g in got] == [w[:2] for w in want] == [(s, 8) for s in range(3, 9)]
    assert all(set(g[2]) == {"data_wait_s", "h2d_wait_s"} for g in got)


def test_a_cpu_batch_is_a_view_of_the_loaders_arrays():
    loader = FakeLoader()
    pf = DevicePrefetcher(loader, depth=0, total_steps=2)
    batch, _, _ = pf.get()
    assert set(batch) == {"inputs", "targets", "mask"}
    for k, t in batch.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert not t.is_pinned()
        assert t.data_ptr() == loader.arrays[0][k].ctypes.data  # no copy
    assert pf.h2d_blocks_consumer and DevicePrefetcher(FakeLoader(), depth=2,
                                                       total_steps=0).h2d_blocks_consumer is False


def test_depth_bounds_the_fetches_ahead():
    loader = FakeLoader()
    pf = DevicePrefetcher(loader, depth=2, total_steps=100)
    try:
        # the queue (depth) plus one item in hand, then the worker waits
        wait_until(lambda: loader.fetches >= 3)
        time.sleep(0.1)
        assert loader.fetches <= 3
        pf.get()
        wait_until(lambda: loader.fetches >= 4)
        time.sleep(0.1)
        assert loader.fetches <= 4  # one consumed, one fetched
    finally:
        pf.stop()


@pytest.mark.parametrize("depth", [2, 0])
def test_stop_iteration_after_a_prefix_and_errors_reraise(depth):
    pf = DevicePrefetcher(FakeLoader(limit=3), depth=depth, total_steps=100)
    assert [g[0] for g in drain(pf)] == [0, 1, 2]
    with pytest.raises(StopIteration):
        pf.get()  # and again: the end is kept
    pf.stop()
    pf = DevicePrefetcher(FakeLoader(fail_at=1), depth=depth, total_steps=10)
    pf.get()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="producer died"):
            pf.get()
    pf.stop()


def test_a_failed_copy_raises_at_get():
    class BadLoader(FakeLoader):
        def generate_batch(self, step):
            return {"inputs": np.array([["not", "numbers"]]), "mask": np.ones(2)}

    pf = DevicePrefetcher(BadLoader(), depth=2, total_steps=5)
    with pytest.raises(TypeError):
        pf.get()
    pf.stop()


def test_stop_joins_the_worker():
    pf = DevicePrefetcher(FakeLoader(), depth=2, total_steps=1000)
    assert wait_until(lambda: any(t.name == "device-prefetch" for t in threading.enumerate()))
    pf.stop()
    assert pf._thread is None
    assert not any(t.name == "device-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert DevicePrefetcher(FakeLoader(), depth=0, total_steps=5)._thread is None


def test_a_mesh_and_other_devices_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        DevicePrefetcher(FakeLoader(), mesh=object())
    with pytest.raises(ValueError, match="cuda or cpu"):
        DevicePrefetcher(FakeLoader(), device="meta")


def test_state_is_the_consumed_position_equal_to_jax(tmp_path):
    data = source_data(tmp_path, "jsonl")
    ref = manager("port", data)
    for i in range(2):
        ref.generate_batch(i)
    want = ref.state_dict()
    ref.stop()
    states = {}
    for pkg, cls in (("port", DevicePrefetcher), ("jax", JPrefetcher)):
        mgr = manager(pkg, data)
        pf = cls(mgr, depth=4, total_steps=100)
        assert pf.state_dict()["docs_consumed"] == 0  # before any get()
        for _ in range(2):
            pf.get()
        wait_until(lambda: pf._queue.qsize() >= 3)  # the worker ran ahead
        states[pkg] = pf.state_dict()
        pf.stop()
        mgr.stop()
    assert states["port"] == states["jax"] == want


@pytest.mark.parametrize("depth", [3, 0])
def test_resume_from_the_prefetchers_state_continues_the_stream(tmp_path, depth):
    data = source_data(tmp_path, "webdataset")
    ref = manager("port", data)
    full = [ref.generate_batch(i)["inputs"] for i in range(6)]
    ref.stop()
    mgr = manager("port", data)
    pf = DevicePrefetcher(mgr, depth=depth, total_steps=100)
    for _ in range(3):
        pf.get()
    state = json.loads(json.dumps(pf.state_dict()))
    pf.stop()
    mgr.stop()
    resumed = manager("port", data)
    resumed.load_state_dict(state)  # before the worker's first fetch, as the trainer does
    pf = DevicePrefetcher(resumed, depth=depth, start_step=3, total_steps=100)
    got = [pf.get()[0]["inputs"].numpy() for _ in range(3)]
    pf.stop()
    resumed.stop()
    for g, w in zip(got, full[3:]):
        np.testing.assert_array_equal(g, w)


def test_trainer_checkpoint_holds_the_consumed_position(tmp_path):
    """With the queue four batches ahead, the step-4 checkpoint holds the
    position of step 4's batch: the prefetch-off run's."""
    data = source_data(tmp_path, "jsonl")
    states, losses = {}, {}
    for depth in (4, 0):
        tr = port_trainer(trainer_config(data, f"d{depth}", iters=8, ckpt=4,
                                         prefetch_depth=depth), str(tmp_path / f"r{depth}"))
        losses[depth] = capture_losses(tr)
        tr.train()
        with open(tr.checkpoints.paths_for_step(4)[2]) as f:
            states[depth] = json.load(f)
    for k in ("step", "docs_consumed", "buf", "source", "total_tokens"):
        assert states[4][k] == states[0][k], k
    assert losses[4] == losses[0]
