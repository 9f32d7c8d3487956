"""The port's checkpoint manager: the JAX package's fault-injection and
checkpoint cases (``tests/test_faults.py``, ``tests/test_checkpoint.py``)
on ``mlx_cuda_distributed_pretraining_tpu_torch.checkpoint``, files read
across the two packages, the async writer's host snapshot, and
``load_trained`` serving only a verified step.
"""

import json
import os
import shutil
import threading
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from mlx_cuda_distributed_pretraining_tpu.checkpoint import CheckpointManager as JManager
from mlx_cuda_distributed_pretraining_tpu.models import llama as jl
from mlx_cuda_distributed_pretraining_tpu.train.trainer import (
    load_trained as j_load_trained,
)
from mlx_cuda_distributed_pretraining_tpu.utils.tree import flatten_dict as jflatten
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint import (
    CheckpointIntegrityError,
    CheckpointManager,
    StaleBackgroundWriteError,
    faults,
)
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.manager import _atomic_json
from mlx_cuda_distributed_pretraining_tpu_torch.checkpoint.safetensors_io import (
    load_safetensors,
    save_safetensors,
)
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager
from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import load_trained
from mlx_cuda_distributed_pretraining_tpu_torch.utils.tree import flatten_dict


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.reset()


PARAMS = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
OPT = {"m": torch.ones(3, 4), "count": torch.tensor(7, dtype=torch.int32)}


def _mgr(tmp_path, name="run", **kw):
    run = CheckpointManager.setup_run_directory(str(tmp_path), name)
    notes = []
    mgr = CheckpointManager(run, notify=notes.append, **kw)
    mgr._notes = notes
    return mgr


def _save(mgr, step, **kw):
    mgr.save(step, {"w": PARAMS["w"] + float(step)}, OPT, {"step": step}, **kw)


def _qnames(mgr):
    return os.listdir(os.path.join(mgr.checkpoint_dir, "quarantine"))


def _truncate(path, size):
    with open(path, "r+b") as f:
        f.truncate(size)


# -- manifests and injected write faults --------------------------------------

def test_manifest_written_last_and_verifies(tmp_path):
    mgr = _mgr(tmp_path)
    _save(mgr, 10)
    with open(mgr.manifest_path(10)) as f:
        manifest = json.load(f)
    assert set(manifest["artifacts"]) == {
        "step_10_model.safetensors", "step_10_optimizer.safetensors",
        "step_10_state.json"}
    for name, info in manifest["artifacts"].items():
        assert info["bytes"] == os.path.getsize(os.path.join(mgr.checkpoint_dir, name))
    assert mgr.verify(10) == (True, "ok")
    assert mgr.latest_complete_step() == "10"


# (fault point, mode, options, reason verify gives): each corrupts step 2;
# resume falls back to step 1 and, but for the dropped manifest, quarantines.
WRITE_FAULTS = [
    ("manifest", "drop", {}, "no manifest"),
    ("model", "truncate", {"truncate_bytes": 16}, "size mismatch"),
    ("optimizer", "drop", {}, "missing artifact"),
    ("manifest", "truncate", {"truncate_bytes": 40}, "torn manifest"),
    ("state", "truncate", {"truncate_bytes": 4}, "size mismatch"),
]


@pytest.mark.parametrize("point,mode,opts,reason", WRITE_FAULTS,
                         ids=[f"{p}-{m}" for p, m, _, _ in WRITE_FAULTS])
def test_injected_write_fault_falls_back_to_the_older_step(tmp_path, point, mode,
                                                           opts, reason):
    mgr = _mgr(tmp_path)
    _save(mgr, 1)
    with faults.active(point, mode, match="step_2", **opts) as rule:
        _save(mgr, 2)
    assert rule.hits == 1
    ok, why = mgr.verify(2)
    assert not ok and reason in why
    assert mgr.latest_complete_step() == "1"
    if reason == "no manifest":  # never a candidate: nothing to quarantine
        assert mgr.latest_step() == "2"  # the unverified scan would take it
    else:
        assert any(n.startswith("step_2") for n in _qnames(mgr))
        assert any("quarantined checkpoint step 2" in n for n in mgr._notes)


def test_enospc_on_blocking_model_write_raises_and_leaves_no_manifest(tmp_path):
    mgr = _mgr(tmp_path)
    _save(mgr, 1)
    rule = faults.inject("model", "enospc", match="step_2")
    with pytest.raises(OSError):
        _save(mgr, 2)
    assert rule.hits == 1 and not os.path.isfile(mgr.manifest_path(2))
    assert mgr.latest_complete_step() == "1"


def test_enospc_during_background_write_surfaces_and_resume_falls_back(tmp_path):
    mgr = _mgr(tmp_path)
    _save(mgr, 1)
    faults.inject("model", "enospc", match="step_2")
    _save(mgr, 2, blocking=False)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        mgr.wait()
    assert mgr.latest_complete_step() == "1"


def test_bitrot_after_write_detected_by_crc(tmp_path):
    mgr = _mgr(tmp_path)
    _save(mgr, 1)
    _save(mgr, 2)
    model2 = mgr.paths_for_step(2)[0]
    with open(model2, "r+b") as f:
        f.seek(os.path.getsize(model2) - 8)
        f.write(b"\xff" * 8)
    ok, reason = mgr.verify(2)
    assert not ok and "crc32 mismatch" in reason
    assert mgr.latest_complete_step() == "1"


def test_fallback_walks_multiple_corrupt_steps(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2, 3, 4):
        _save(mgr, s)
    for s in (2, 3, 4):
        _truncate(mgr.paths_for_step(s)[0], 10)
    assert mgr.latest_complete_step() == "1"
    for s in (2, 3, 4):
        assert f"step_{s}_model.safetensors" in _qnames(mgr)


def test_legacy_unmanifested_checkpoints_still_resumable(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2):
        _save(mgr, s)
        os.unlink(mgr.manifest_path(s))
    assert mgr.latest_complete_step() == "2"
    assert any("predate integrity manifests" in n for n in mgr._notes)


def test_mixed_era_falls_back_to_legacy_after_quarantine(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2):
        _save(mgr, s)
    os.unlink(mgr.manifest_path(1))  # step 1 is now from before manifests
    _truncate(mgr.paths_for_step(2)[0], 10)  # the only manifested step is corrupt
    assert mgr.latest_complete_step() == "1"
    assert any("resuming unverified pre-manifest step 1" in n for n in mgr._notes)
    assert "step_2.manifest.json" in _qnames(mgr)


def test_read_only_scan_skips_without_quarantining(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2):
        _save(mgr, s)
    model2 = mgr.paths_for_step(2)[0]
    _truncate(model2, 10)
    assert mgr.latest_complete_step(quarantine=False) == "1"
    assert os.path.isfile(model2) and os.path.isfile(mgr.manifest_path(2))
    assert not os.path.isdir(os.path.join(mgr.checkpoint_dir, "quarantine"))
    assert any("read-only scan" in n for n in mgr._notes)
    # the failed candidate, still on disk, is never the legacy fallback
    os.unlink(mgr.manifest_path(1))
    assert mgr.latest_complete_step(quarantine=False) == "1"


def test_sidecar_folded_into_the_manifest_and_injectable(tmp_path):
    mgr = _mgr(tmp_path)
    sidecar = os.path.join(mgr.checkpoint_dir, "step_5_data_p0.json")
    _atomic_json(sidecar, {"val_ptr": 123})
    _save(mgr, 5)
    with open(mgr.manifest_path(5)) as f:
        assert "step_5_data_p0.json" in json.load(f)["artifacts"]
    assert mgr.data_sidecar_states(5) == {0: {"val_ptr": 123}}
    _truncate(sidecar, 4)
    ok, reason = mgr.verify(5)
    assert not ok and "step_5_data_p0.json" in reason
    with faults.active("sidecar", "enospc"):
        with pytest.raises(OSError):
            _atomic_json(sidecar, {"val_ptr": 1})


# -- optimizer state that is missing, unreadable or partial ---------------------

def _missing(mgr, opt_path):
    os.unlink(opt_path)
    return OPT, "MISSING"


def _garbled(mgr, opt_path):
    with open(opt_path, "wb") as f:
        f.write(b"garbage that is not safetensors")
    return OPT, "UNREADABLE"


def _short(mgr, opt_path):
    return dict(OPT, extra=torch.zeros(2)), "lacks"


@pytest.mark.parametrize("damage", [_missing, _garbled, _short],
                         ids=["missing", "unreadable", "partial"])
def test_degraded_optimizer_state_warns_and_strict_raises(tmp_path, damage):
    mgr = _mgr(tmp_path)
    _save(mgr, 1)
    like, word = damage(mgr, mgr.paths_for_step(1)[1])
    _, opt_state, _ = mgr.load(1, like_params=PARAMS, like_opt_state=like)
    assert (opt_state is not None) == (word == "lacks")  # partial: rebuilt, loudly
    assert any(word in n for n in mgr._notes)
    with pytest.raises(CheckpointIntegrityError, match=word):
        mgr.load(1, like_params=PARAMS, like_opt_state=like, strict=True)


# -- retention GC and the ledger ---------------------------------------------------

def test_retention_gc_keep_last_and_keep_every(tmp_path):
    mgr = _mgr(tmp_path, keep_last=2, keep_every=10)
    for s in (5, 10, 15, 20, 25):
        _save(mgr, s)
    assert set(mgr.manifested_steps()) == {"10", "20", "25"}
    assert not os.path.exists(mgr.paths_for_step(5)[0])
    assert mgr.verify(10) == (True, "ok")


def test_retention_gc_never_deletes_final_or_protected(tmp_path):
    mgr = _mgr(tmp_path, keep_last=1)
    mgr.protect_steps.add("1")  # the resume source
    for s in (1, 2, 3):
        _save(mgr, s)
    mgr.save("final", PARAMS, OPT, {"step": 3})
    assert set(mgr.manifested_steps()) == {"final", "1", "3"}


def test_retention_disabled_by_default_and_prunes_the_ledger(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2, 3, 4):
        _save(mgr, s)
    assert set(mgr.manifested_steps()) == {"1", "2", "3", "4"}
    mgr = _mgr(tmp_path, name="gc", keep_last=2)
    for s in (1, 2, 3, 4):
        _save(mgr, s)
    with open(os.path.join(mgr.run_dir, "metadata.json")) as f:
        ledger = json.load(f)
    assert [e["step"] for e in ledger["checkpoints"]] == [3, 4]
    assert all(os.path.isfile(e["path"]) for e in ledger["checkpoints"])


def test_corrupt_ledger_preserved_and_rebuilt_from_scan(tmp_path):
    mgr = _mgr(tmp_path)
    for s in (1, 2):
        _save(mgr, s)
    meta = os.path.join(mgr.run_dir, "metadata.json")
    with open(meta, "w") as f:
        f.write('{"checkpoints": [tru')  # torn mid-write
    _save(mgr, 3)  # the next append must not reset the ledger
    with open(meta) as f:
        ledger = json.load(f)
    assert [e["step"] for e in ledger["checkpoints"]] == [1, 2, 3]
    assert all(e.get("rebuilt") for e in ledger["checkpoints"][:2])
    assert os.path.isfile(meta + ".corrupt")
    assert any("rebuilding the ledger" in n for n in mgr._notes)


# -- the background writer -----------------------------------------------------------

def test_async_save_matches_blocking(tmp_path):
    mgr = _mgr(tmp_path)
    for step in (10, 20):
        mgr.save(step, {"w": PARAMS["w"] + step}, OPT,
                 {"step": step, "total_tokens": step * 5}, blocking=False)
    mgr.save("final", {"w": PARAMS["w"] + 99}, OPT, {"step": 30})  # blocking
    mgr.wait()
    for step, off in ((10, 10), (20, 20), ("final", 99)):
        loaded, lopt, _ = mgr.load(step, like_params=PARAMS, like_opt_state=OPT)
        torch.testing.assert_close(loaded["w"], PARAMS["w"] + off, rtol=0, atol=0)
        assert int(lopt["count"]) == 7 and lopt["count"].dtype == torch.int32
    with open(os.path.join(mgr.run_dir, "metadata.json")) as f:
        assert [e["step"] for e in json.load(f)["checkpoints"]] == [10, 20, "final"]


def test_async_save_snapshots_before_returning(tmp_path):
    """The optimizers update in place: tensors mutated right after an async
    save, while its write is held back, must not reach the file."""
    mgr = _mgr(tmp_path)
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    opt = {"m": torch.ones(3, 4), "count": torch.tensor(3, dtype=torch.int32)}
    gate = threading.Event()
    try:
        faults.inject("model", "block", match="step_1", event=gate)
        mgr.save(1, params, opt, {"step": 1}, blocking=False)
        params["w"].mul_(-1.0).add_(5.0)  # the next step's in-place updates
        opt["m"].zero_()
        opt["count"] += 1
    finally:
        gate.set()
    mgr.wait()
    assert mgr.verify(1) == (True, "ok")
    loaded, lopt, _ = mgr.load(1, like_params=params, like_opt_state=opt)
    torch.testing.assert_close(loaded["w"], torch.arange(12.0).reshape(3, 4),
                               rtol=0, atol=0)
    torch.testing.assert_close(lopt["m"], torch.ones(3, 4), rtol=0, atol=0)
    assert int(lopt["count"]) == 3


def test_stale_background_write_error_lands_the_blocking_save(tmp_path):
    """A failed background write must not abort a later blocking save (the
    final or preemption checkpoint): it lands, manifest and all, and then
    :class:`StaleBackgroundWriteError` surfaces; a later wait() is clean."""
    mgr = _mgr(tmp_path)
    faults.inject("model", "enospc", match="step_2")
    _save(mgr, 2, blocking=False)
    mgr._queue.join()  # the background write consumes the fault
    with pytest.raises(StaleBackgroundWriteError) as exc:
        mgr.save("final", PARAMS, OPT, {"step": 3})
    assert issubclass(StaleBackgroundWriteError, RuntimeError)
    assert "No space" in str(exc.value) or "ENOSPC" in str(exc.value)
    assert mgr.verify("final") == (True, "ok")
    assert mgr.latest_complete_step() == "final"
    mgr.wait()


def test_async_error_from_an_unwritable_dir_surfaces(tmp_path):
    mgr = _mgr(tmp_path)
    _save(mgr, 1, blocking=False)
    mgr.wait()
    shutil.rmtree(mgr.checkpoint_dir)
    with open(mgr.checkpoint_dir, "w") as f:
        f.write("not a dir")
    _save(mgr, 2, blocking=False)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        mgr.wait()


def test_async_backpressure_blocks_at_two_in_flight(tmp_path):
    mgr = _mgr(tmp_path)
    gate = threading.Event()
    third_done = threading.Event()
    try:
        faults.inject("model", "block", match="step_1", event=gate)
        _save(mgr, 1, blocking=False)  # the writer parks on the gate
        _save(mgr, 2, blocking=False)  # fills the queue slot

        def third():
            _save(mgr, 3, blocking=False)
            third_done.set()

        t = threading.Thread(target=third)
        t.start()
        time.sleep(0.3)
        assert not third_done.is_set(), "a third save should block on put()"
        gate.set()
        t.join(timeout=30)
        assert not t.is_alive() and third_done.is_set()
        mgr.wait()
    finally:
        gate.set()
    with open(os.path.join(mgr.run_dir, "metadata.json")) as f:
        assert [e["step"] for e in json.load(f)["checkpoints"]] == [1, 2, 3]
    for step in (1, 2, 3):
        assert mgr.verify(step) == (True, "ok")


# -- across the two packages ---------------------------------------------------------

def test_checkpoints_cross_between_the_packages(tmp_path):
    """A step written by either manager verifies, resolves and loads in the
    other: model, optimizer tensors (an int32 0-dim count) and the empty
    states of stateless links, which ride the safetensors metadata."""
    t_opt = [{}, {"count": torch.tensor(4, dtype=torch.int32), "v": torch.ones(3, 4)}]
    j_opt = [{}, {"count": np.asarray(4, np.int32), "v": np.ones((3, 4), np.float32)}]
    tmgr = _mgr(tmp_path, name="port")
    tmgr.save(3, PARAMS, t_opt, {"step": 3})
    jmgr = JManager(tmgr.run_dir)
    assert jmgr.verify(3) == (True, "ok") and jmgr.latest_complete_step() == "3"
    jp, jo, js = jmgr.load(3, like_params={"w": np.zeros((3, 4), np.float32)},
                           like_opt_state=j_opt, strict=True)
    np.testing.assert_array_equal(jp["w"], PARAMS["w"].numpy())
    assert jo[0] == {} and int(jo[1]["count"]) == 4 and js["step"] == 3

    run = str(tmp_path / "jax")
    os.makedirs(os.path.join(run, "checkpoints"))
    JManager(run).save(5, {"w": PARAMS["w"].numpy() + 5}, j_opt, {"step": 5})
    tmgr = CheckpointManager(run)
    assert tmgr.latest_complete_step() == "5"
    tp, to, ts = tmgr.load(5, like_params=PARAMS, like_opt_state=t_opt, strict=True)
    torch.testing.assert_close(tp["w"], PARAMS["w"] + 5, rtol=0, atol=0)
    assert to[0] == {} and to[1]["count"].dtype == torch.int32 and int(to[1]["count"]) == 4
    assert ts["step"] == 5


def test_safetensors_writer_returns_the_bytes_it_streamed(tmp_path):
    tensors = {"a": torch.randn(5, 7).to(torch.bfloat16), "b": torch.tensor(3),
               "c": torch.zeros(0, 4), "d": torch.ones(4, dtype=torch.bool)}
    path = str(tmp_path / "x.safetensors")
    nbytes, crc = save_safetensors(path, tensors)
    data = open(path, "rb").read()
    assert (nbytes, crc) == (len(data), zlib.crc32(data))
    back, _ = load_safetensors(path)
    for k, v in tensors.items():
        assert torch.equal(back[k], v), k


# -- load_trained serves only a verified step ----------------------------------------

def test_load_trained_skips_a_torn_newer_step_as_jax_does(tmp_path):
    """A good step 10, then a step 20 whose model file is cut short after
    its manifest was written (a crash mid-save): JAX's load_trained serves
    step 10, and so must the port's (it tried step 20's torn file)."""
    jargs = jl.LlamaArgs(vocab_size=259, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8)
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0), jargs))
    rng = np.random.default_rng(0)
    good = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in jflatten(shapes).items()}
    mgr = _mgr(tmp_path, name="torn")
    cfg = {"name": "torn", "model": {
        "dimensions": {"hidden_size": 32, "intermediate_size": 64, "num_layers": 2},
        "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}}}
    with open(os.path.join(mgr.run_dir, "config.yaml"), "w") as f:
        json.dump(cfg, f)
    TokenizerManager().save_to_run_dir(mgr.run_dir)
    as_torch = lambda flat: {k: torch.from_numpy(v) for k, v in flat.items()}
    mgr.save(10, as_torch(good), None, {"step": 10})
    mgr.save(20, as_torch({k: v + 1.0 for k, v in good.items()}), None, {"step": 20})
    model20 = mgr.paths_for_step(20)[0]
    _truncate(model20, os.path.getsize(model20) - 64)

    jp, *_ = j_load_trained(mgr.run_dir)
    tp, *_ = load_trained(mgr.run_dir, device="cpu")
    j_flat = jflatten(jax.tree_util.tree_map(np.asarray, jp))
    t_flat = {k: v.numpy() for k, v in flatten_dict(tp).items()}
    for k, v in good.items():
        np.testing.assert_array_equal(j_flat[k], v, err_msg=k)
        np.testing.assert_array_equal(t_flat[k], v, err_msg=k)
    assert os.path.isfile(model20)  # skipped in place, not quarantined
