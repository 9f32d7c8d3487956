"""The torch port's tool-use agent (``infer/agent.py``) against the JAX
package's: the cases of ``tests/test_agent.py`` on the port, the tools'
answers equal to JAX's on the same inputs, and the agent's entry point on a
tiny run written by the port's trainer, on the CPU."""

import json

import pytest

from mlx_cuda_distributed_pretraining_tpu.infer import agent as jagent
from mlx_cuda_distributed_pretraining_tpu_torch.infer.agent import (
    default_tools,
    main,
    run_agent,
    safe_calc,
    tool_prompt,
    word_count,
)

EXPRESSIONS = ["2+2*3", "(10 - 4) / 3", "2**10", "__import__('os')",
               "open('/etc/passwd')", "x + 1", "1/0", "9**9**9",
               "10**300 * 10**300", "2**64", "-3 % 5", "7 // 2", "1e15 * 10"]


def test_safe_calc_arithmetic():
    assert safe_calc("2+2*3") == "8"
    assert safe_calc("(10 - 4) / 3") == "2.0"
    assert safe_calc("2**10") == "1024"


def test_safe_calc_rejects_code():
    assert safe_calc("__import__('os')").startswith("error")
    assert safe_calc("open('/etc/passwd')").startswith("error")
    assert safe_calc("x + 1").startswith("error")
    assert safe_calc("1/0").startswith("error")


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_tools_answer_as_jax(expr):
    assert safe_calc(expr) == jagent.safe_calc(expr)
    assert word_count(expr) == jagent.word_count(expr)


def test_agent_executes_tool_and_feeds_result_back():
    contexts = []

    def fake_gen(context):
        contexts.append(context)
        if len(contexts) == 1:
            return "Let me compute that. <<calc: 6*7>>"
        return "The answer is 42."

    final, trace = run_agent(fake_gen, "what is 6*7?")
    assert final == "The answer is 42."
    assert trace[0].tool == "calc" and trace[0].result == "42"
    assert "<<result: 42>>" in contexts[1]
    assert "calc" in contexts[0] and "what is 6*7?" in contexts[0]


def test_agent_discards_speculation_after_tool_call():
    calls = []

    def fake_gen(context):
        calls.append(context)
        if len(calls) == 1:
            return "<<calc: 1+1>> and then I guess the answer is 7"
        return "It is 2."

    final, trace = run_agent(fake_gen, "1+1?")
    assert final == "It is 2."
    assert "I guess" not in trace[0].text


def test_agent_unknown_tool_reports_error():
    calls = iter(["<<frobnicate: x>>", "ok"])

    final, trace = run_agent(lambda context: next(calls), "hi")
    assert trace[0].result.startswith("error: unknown tool")
    assert final == "ok"


def test_agent_turn_budget():
    final, trace = run_agent(lambda context: "<<calc: 1+1>>", "loop forever", max_turns=3)
    assert len(trace) == 3
    assert all(s.tool == "calc" for s in trace)


def test_tool_prompt_lists_tools():
    p = tool_prompt(default_tools())
    assert "calc" in p and "wordcount" in p
    assert p == jagent.tool_prompt(jagent.default_tools())


def test_safe_calc_caps_magnitude_and_exponent():
    assert safe_calc("9**9**9").startswith("error")
    assert safe_calc("10**300 * 10**300").startswith("error")
    assert safe_calc("2**64").startswith("error")
    assert safe_calc("2**10") == "1024"


def test_agent_loop_equals_jax_on_a_scripted_model():
    # the same scripted generations through both loops: the same contexts,
    # the same trace and the same final answer
    script = ["First <<calc: 3*(4+5)>> then more", "<<wordcount: a b c d>>",
              "<<nosuch: 1>>", "Done: 27."]

    def scripted(log):
        replies = iter(script)

        def gen(context):
            log.append(context)
            return next(replies)

        return gen

    tlog, jlog = [], []
    tfinal, ttrace = run_agent(scripted(tlog), "compute")
    jfinal, jtrace = jagent.run_agent(scripted(jlog), "compute")
    assert tfinal == jfinal == "Done: 27." and tlog == jlog
    assert [(s.text, s.tool, s.args, s.result) for s in ttrace] == \
        [(s.text, s.tool, s.args, s.result) for s in jtrace]


def test_agent_entry_point_on_a_port_run(tmp_path, capsys):
    from mlx_cuda_distributed_pretraining_tpu_torch.config import Config
    from mlx_cuda_distributed_pretraining_tpu_torch.infer.generate import generate_text
    from mlx_cuda_distributed_pretraining_tpu_torch.train.trainer import Trainer, load_trained

    train = tmp_path / "train.jsonl"
    train.write_text("\n".join(json.dumps({"text": "what is 6*7? <<calc: 6*7>> 42 "})
                               for _ in range(20)) + "\n")
    cfg = {"name": "tiny-agent", "overwrite": True,
           "data": {"input_file": str(train),
                    "preprocessing": {"max_context_size": 32},
                    "tokenizer": {"normal_vocab_size": 256}},
           "model": {"architecture": "llama",
                     "dimensions": {"hidden_size": 32, "intermediate_size": 64,
                                    "num_layers": 2},
                     "attention": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}},
           "training": {"hyperparameters": {"batch_size": 4, "learning_rate": 1e-2,
                                            "iters": 3},
                        "optimization": {"optimizer": "adamw"}},
           "logging": {"steps": {"logging_interval": 3, "checkpoint_interval": 100}},
           "system": {"seed": 0}}
    runs = str(tmp_path / "runs")
    Trainer(Config.from_dict(cfg), runs_root=runs, quiet=True, device="cpu").train()
    final = main(["--run", "tiny-agent", "--runs-root", runs, "--device", "cpu",
                  "--prompt", "what is 6*7?", "--max-tokens", "8",
                  "--max-turns", "2", "--temperature", "0"])
    params, args, tok, _ = load_trained("tiny-agent", runs_root=runs, device="cpu")
    _, trace = run_agent(
        lambda c: generate_text(params, args, tok, c, max_new_tokens=8), "what is 6*7?",
        max_turns=2)
    assert final == trace[-1].text
    assert capsys.readouterr().out.rstrip("\n").endswith(final)
