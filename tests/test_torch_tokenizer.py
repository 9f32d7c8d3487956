"""The port's HF tokenizer and run-directory tokenizer against the JAX
package's, on the CPU.

A byte-level BPE ``tokenizer.json`` is trained here (``tokenizers``, no
download). Ids, decode, the special tokens and ``tokenize_doc`` must equal
JAX's; a run directory written by either package loads in the other. The
port's modules must import where ``tokenizers`` and ``datasets`` are not
installed (the card's machine has neither).
"""

import os
import subprocess
import sys

import pytest

from mlx_cuda_distributed_pretraining_tpu.config import DataConfig as JDataConfig
from mlx_cuda_distributed_pretraining_tpu.tokenizer import TokenizerManager as JTok
from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig as TDataConfig
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import HFTokenizer
from mlx_cuda_distributed_pretraining_tpu_torch.tokenizer import TokenizerManager as TTok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world", "häßlich 🎉 and more", "abc<eos>def", "", "  spaces  ",
         "hello<bos>world<pad>", "a" * 300]


def train_tokenizer(path, specials=("<pad>", "<bos>", "<eos>")):
    """A byte-level BPE tokenizer.json trained on a few strings."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=list(specials),
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["hello world häßlich 🎉", "the quick brown fox"] * 8, trainer)
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))
    return path


@pytest.fixture
def tok_dir(tmp_path):
    return train_tokenizer(tmp_path / "tok")


def _pair(**data):
    return JTok(JDataConfig(**data)), TTok(TDataConfig(**data))


def _assert_same(j, t):
    assert type(t.tokenizer).__name__ == type(j.tokenizer).__name__
    assert (t.vocab_size, t.pad_id, t.bos_id, t.eos_id) == (
        j.vocab_size, j.pad_id, j.bos_id, j.eos_id)
    for text in TEXTS:
        ids = j.tokenize(text)
        assert t.tokenize(text) == ids
        assert t.detokenize(ids) == j.detokenize(ids)
        assert t.tokenize_doc(text, max_length=5) == j.tokenize_doc(text, max_length=5)
        assert t.tokenize_doc(text) == j.tokenize_doc(text)


@pytest.mark.parametrize("where", ["dir", "file"])
def test_hf_tokenizer_ids_decode_and_specials_match_jax(tok_dir, where):
    path = str(tok_dir if where == "dir" else tok_dir / "tokenizer.json")
    j, t = _pair(tokenizer_path=path, preprocessing={"max_context_size": 16})
    assert t.external_path == j.external_path == str(tok_dir / "tokenizer.json")
    assert isinstance(t.tokenizer, HFTokenizer)
    _assert_same(j, t)
    # a literal special token in the text maps to its id, and decode drops it
    ids = t.tokenize("abc<eos>def")
    assert t.eos_id in ids and "<eos>" not in t.detokenize(ids)
    assert t.detokenize(t.tokenize("häßlich 🎉")) == "häßlich 🎉"


def test_hf_tokenizer_without_the_special_tokens_keeps_jax_defaults(tmp_path):
    tok_dir = train_tokenizer(tmp_path / "tok", specials=("[UNK]",))
    j, t = _pair(tokenizer_path=str(tok_dir))
    assert t.tokenizer.special_token_ids == j.tokenizer.special_token_ids == {}
    _assert_same(j, t)


def test_a_missing_tokenizer_path_falls_back_to_bytes_as_in_jax(tmp_path):
    j, t = _pair(tokenizer_path=str(tmp_path / "nothing-here"))
    assert t.external_path is None and j.external_path is None
    _assert_same(j, t)


@pytest.mark.parametrize("kind", ["hf", "byte"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_directory_tokenizer_reads_across_packages(tmp_path, tok_dir, kind, writer):
    data = ({"tokenizer_path": str(tok_dir)} if kind == "hf" else
            {"tokenizer": {"normal_vocab_size": 200,
                           "special_tokens": {"pad": "<p>", "bos": "<b>", "eos": "<e>",
                                              "sep": "<s>"}}})
    run_dir = str(tmp_path / "run")
    make = {"jax": lambda: JTok(JDataConfig(**data), run_dir=run_dir),
            "port": lambda: TTok(TDataConfig(**data), run_dir=run_dir)}
    make[writer]()
    name = "tokenizer.json" if kind == "hf" else "byte_tokenizer.json"
    assert sorted(os.listdir(os.path.join(run_dir, "tokenizer"))) == [name]
    if kind == "hf":  # the external file is copied into the run as it is
        with open(os.path.join(run_dir, "tokenizer", name), "rb") as f:
            assert f.read() == (tok_dir / "tokenizer.json").read_bytes()
    j, t = JTok.from_run_dir(run_dir), TTok.from_run_dir(run_dir)
    _assert_same(j, t)
    want = make["jax"]()  # the tokenizer the run was written with
    assert t.vocab_size == want.vocab_size
    assert t.tokenize(TEXTS[1]) == want.tokenize(TEXTS[1])


def test_port_imports_without_tokenizers_and_datasets():
    """The card's machine has neither package: the port's tokenizer, its
    streaming module and its trainer import, the byte tokenizer works, and
    only loading a tokenizer.json needs ``tokenizers``."""
    code = (
        "import sys\n"
        "sys.modules['datasets'] = None\n"
        "sys.modules['tokenizers'] = None\n"
        "from mlx_cuda_distributed_pretraining_tpu_torch import tokenizer\n"
        "from mlx_cuda_distributed_pretraining_tpu_torch.data import streaming\n"
        "from mlx_cuda_distributed_pretraining_tpu_torch.train import trainer\n"
        "from mlx_cuda_distributed_pretraining_tpu_torch.config import DataConfig\n"
        "m = tokenizer.TokenizerManager(DataConfig())\n"
        "assert m.tokenize_doc('ab') == [m.bos_id, 97, 98, m.eos_id]\n"
        "try:\n"
        "    tokenizer.HFTokenizer('tokenizer.json')\n"
        "except ImportError:\n"
        "    print('no tokenizers')\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'mlx_cuda_distributed_"
        "pretraining_tpu.')) for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["no", "tokenizers", "ok"]
