"""The port's token shards against the JAX package's, on the CPU.

``write_token_shards`` must write the same files byte for byte (uint16 and
uint32 shards, ``index.json``, a token budget), so shards written by either
package train in the other; ``TokenShardDataManager`` must give JAX's train
batches (across epochs, one host or host 1 of 2) and validation batches;
and the port's trainer on ``source: token_shards`` takes the vocabulary from
the shard index and gives JAX's losses.
"""

import json
import os

import numpy as np
import pytest

from mlx_cuda_distributed_pretraining_tpu.config import Config as JConfig
from mlx_cuda_distributed_pretraining_tpu.config import DataConfig as JDataConfig
from mlx_cuda_distributed_pretraining_tpu.data.token_shards import (
    TokenShardDataManager as JShards,
)
from mlx_cuda_distributed_pretraining_tpu.data.token_shards import (
    write_token_shards as j_write,
)
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu.train.trainer import Trainer as JTrainer
from mlx_cuda_distributed_pretraining_tpu_torch.config import Config as TConfig
from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig as TDataConfig
from mlx_cuda_distributed_pretraining_tpu_torch.data.token_shards import (
    TokenShardDataManager as TShards,
)
from mlx_cuda_distributed_pretraining_tpu_torch.data.token_shards import (
    write_token_shards as t_write,
)
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok


def _docs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    words = ["ka", "lomi", "ne", "suta", "ripo", "an", "elor", "ve", "ü"]
    return [" ".join(rng.choice(words, size=int(rng.integers(3, 60)))) for _ in range(n)]


class WideTokenizer:
    """A tokenizer whose ids need uint32 shards (vocabulary above 65535)."""

    vocab_size = 70_000
    eos_id = 69_999

    def tokenize(self, text):
        return [(ord(c) * 611 + i) % 69_999 for i, c in enumerate(text)]


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("shard_tokens,max_tokens,append_eos", [
    (500, None, True), (777, 3000, True), (1 << 20, None, False), (400, 400, True)])
@pytest.mark.parametrize("wide", [False, True])
def test_written_shards_are_byte_identical(tmp_path, shard_tokens, max_tokens,
                                           append_eos, wide):
    toks = ((WideTokenizer(), WideTokenizer()) if wide else
            (JTok(JDataConfig()), TTok(TDataConfig())))
    kw = dict(shard_tokens=shard_tokens, max_tokens=max_tokens, append_eos=append_eos)
    j_index = j_write(iter(_docs()), toks[0], str(tmp_path / "j"), **kw)
    t_index = t_write(iter(_docs()), toks[1], str(tmp_path / "t"), **kw)
    assert t_index == j_index
    assert t_index["dtype"] == ("uint32" if wide else "uint16")
    assert _dir_bytes(tmp_path / "t") == _dir_bytes(tmp_path / "j")


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_train_and_validation_batches_equal_jax(tmp_path, process_index, process_count):
    t_write(iter(_docs(300)), TTok(TDataConfig()), str(tmp_path / "s"), shard_tokens=2000)
    kw = dict(batch_size=4, seq_len=31, seed=5, process_index=process_index,
              process_count=process_count, val_fraction=0.05)
    j, t = JShards(str(tmp_path / "s"), **kw), TShards(str(tmp_path / "s"), **kw)
    assert (t.n_train, t.batches_per_epoch, t.per_host) == (
        j.n_train, j.batches_per_epoch, j.per_host)
    for step in list(range(5)) + [t.batches_per_epoch - 1, t.batches_per_epoch + 2]:
        jb, tb = j.generate_batch(step), t.generate_batch(step)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    jv, tv = list(j.iter_validation(cap=3)), list(t.iter_validation(cap=3))
    assert len(tv) == len(jv) > 0
    for jb, tb in zip(jv, tv):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert t.state_dict() == j.state_dict() and t.has_validation_data


def test_too_few_tokens_raise_as_in_jax(tmp_path):
    t_write(iter(["ab"]), TTok(TDataConfig()), str(tmp_path / "s"))
    with pytest.raises(ValueError, match="2 windows"):
        TShards(str(tmp_path / "s"), batch_size=2, seq_len=64)
    with pytest.raises(ValueError, match="2 windows"):
        JShards(str(tmp_path / "s"), batch_size=2, seq_len=64)


def _train_cfg(shard_dir, name, **extra):
    d = {"name": name, "overwrite": True,
         "data": {"source": "token_shards", "input_file": shard_dir,
                  "preprocessing": {"max_context_size": 32},
                  "tokenizer": {"normal_vocab_size": 256}},
         "model": {"architecture": "llama",
                   "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                  "num_layers": 2},
                   "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
         "training": {"hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                          "iters": 5},
                      "optimization": {"optimizer": "adamw"},
                      "scheduler": {"type": "cosine", "min_lr_ratio": 0.1}},
         "logging": {"steps": {"logging_interval": 1, "checkpoint_interval": 0,
                               "validation_interval": 0}},
         "system": {"seed": 0}}
    d["data"].update(extra)
    return d


class ByteTokenizerWithVocab:
    """The byte tokenizer's ids, recorded under a larger vocabulary."""

    def __init__(self, inner, vocab_size):
        self.inner, self.vocab_size, self.eos_id = inner, vocab_size, inner.eos_id

    def tokenize(self, text):
        return self.inner.tokenize(text)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trainer_on_token_shards_matches_jax(tmp_path, writer):
    from test_torch_streaming import (
        assert_same_losses,
        capture_losses,
        initial_weights,
        port_trainer,
    )

    shard_dir = str(tmp_path / "shards")
    tok = ByteTokenizerWithVocab(TTok(TDataConfig()), 300)
    (j_write if writer == "jax" else t_write)(iter(_docs(200)), tok, shard_dir,
                                              shard_tokens=1500)
    d = _train_cfg(shard_dir, f"shards-{writer}")
    jtr = JTrainer(JConfig.from_dict(d), runs_root=str(tmp_path / "jr"), quiet=True)
    tr = port_trainer(d, str(tmp_path / "tr"), init=initial_weights(jtr))
    losses = {}
    for pkg, trainer in (("jax", jtr), ("port", tr)):
        assert trainer.model_args.vocab_size == 300  # the shard index's
        losses[pkg] = capture_losses(trainer)
        result = trainer.train()
        assert result["final_val_loss"] is not None  # the shards' validation split
    assert_same_losses(losses["port"], losses["jax"], range(1, 6))


def test_shard_dir_under_streaming_and_missing_raise_as_in_jax(tmp_path):
    from mlx_cuda_distributed_pretraining_tpu.data.streaming import (
        build_data_manager as j_build,
    )
    from mlx_cuda_distributed_pretraining_tpu_torch.data.streaming import (
        build_data_manager as t_build,
    )

    t_write(iter(_docs(60)), TTok(TDataConfig()), str(tmp_path / "s"), shard_tokens=900)
    data = {"source": "token_shards", "streaming": {"shard_dir": "s", "val_fraction": 0.1},
            "preprocessing": {"max_context_size": 16}}
    kw = dict(batch_size=2, seq_len=16, base_dir=str(tmp_path))
    t = t_build(TDataConfig(**data), TTok(TDataConfig()), **kw)
    j = j_build(JDataConfig(**data), JTok(JDataConfig()), **kw)
    assert type(t).__name__ == "TokenShardDataManager" and len(t.val_starts) == len(
        j.val_starts)
    np.testing.assert_array_equal(t.generate_batch(3)["inputs"], j.generate_batch(3)["inputs"])
    with pytest.raises(ValueError, match="shard directory"):
        t_build(TDataConfig(source="token_shards"), TTok(TDataConfig()), batch_size=2)
    with open(os.path.join(tmp_path, "s", "index.json")) as f:
        assert json.load(f)["vocab_size"] == 259
