"""Tool-use agent loop over a trained model: the JAX package's
``infer/agent.py``.

The model emits ``<<tool: args>>`` markers; the runtime executes the tool,
feeds ``<<result: ...>>`` back into the context, and generation continues
until a final answer (no marker) or the turn budget runs out. The tools are
pure Python (an arithmetic evaluator and a word count).

Usage:
    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.agent \
        --run <name> --prompt "what is 2+2*3?" [--device cpu]
"""

from __future__ import annotations

import argparse
import ast
import operator
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

_TOOL_RE = re.compile(r"<<(\w+):\s*(.*?)>>", re.DOTALL)

_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_UNARY = {ast.UAdd: operator.pos, ast.USub: operator.neg}


_MAX_ABS = 1e15  # operand/result magnitude cap: model-generated input
_MAX_EXP = 64    # exponent cap (9**9**9 would build a 370M-digit int)


def safe_calc(expr: str) -> str:
    """Arithmetic-only evaluator (no names, calls, or attributes; operand
    magnitudes and exponents capped — the input is model-generated)."""

    def bound(v):
        if abs(v) > _MAX_ABS:
            raise ValueError(f"magnitude exceeds {_MAX_ABS:g}")
        return v

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return bound(node.value)
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            left, right = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Pow) and abs(right) > _MAX_EXP:
                raise ValueError(f"exponent exceeds {_MAX_EXP}")
            return bound(_BINOPS[type(node.op)](left, right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
            return _UNARY[type(node.op)](ev(node.operand))
        raise ValueError(f"unsupported expression element: {ast.dump(node)}")

    try:
        result = ev(ast.parse(expr.strip(), mode="eval"))
    except (SyntaxError, ValueError, ZeroDivisionError, OverflowError, MemoryError) as e:
        return f"error: {e}"
    return repr(result)


def word_count(text: str) -> str:
    return str(len(text.split()))


@dataclass
class Tool:
    name: str
    description: str
    fn: Callable[[str], str]


def default_tools() -> Dict[str, Tool]:
    return {
        "calc": Tool("calc", "evaluate an arithmetic expression, e.g. <<calc: 2+2*3>>", safe_calc),
        "wordcount": Tool("wordcount", "count words in text, e.g. <<wordcount: some text>>", word_count),
    }


def tool_prompt(tools: Dict[str, Tool]) -> str:
    lines = ["You can call tools by writing <<name: args>>. Available tools:"]
    for t in tools.values():
        lines.append(f"- {t.name}: {t.description}")
    lines.append("Tool results appear as <<result: ...>>. Answer directly when done.")
    return "\n".join(lines)


@dataclass
class AgentStep:
    text: str
    tool: Optional[str] = None
    args: Optional[str] = None
    result: Optional[str] = None


def run_agent(
    generate_fn: Callable[[str], str],
    prompt: str,
    tools: Optional[Dict[str, Tool]] = None,
    max_turns: int = 5,
) -> Tuple[str, List[AgentStep]]:
    """Run the tool loop.

    ``generate_fn(context) -> continuation``. Returns ``(final_text,
    trace)`` where trace records each turn's generation and tool execution.
    """
    tools = tools if tools is not None else default_tools()
    context = tool_prompt(tools) + "\n\n" + prompt
    trace: List[AgentStep] = []
    for _ in range(max_turns):
        out = generate_fn(context)
        m = _TOOL_RE.search(out)
        if not m or m.group(1) == "result":
            trace.append(AgentStep(text=out))
            return out, trace
        name, args = m.group(1), m.group(2).strip()
        # execute only up to the first tool call; discard speculation after it
        upto = out[: m.end()]
        if name in tools:
            result = tools[name].fn(args)
        else:
            result = f"error: unknown tool '{name}'"
        trace.append(AgentStep(text=upto, tool=name, args=args, result=result))
        context = context + upto + f" <<result: {result}>> "
    return trace[-1].text if trace else "", trace


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Tool-use agent over a trained run")
    parser.add_argument("--run", required=True)
    parser.add_argument("--runs-root", default="runs")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt", required=True)
    parser.add_argument("--max-tokens", type=int, default=128)
    parser.add_argument("--max-turns", type=int, default=5)
    parser.add_argument("--temperature", type=float, default=0.7)
    a = parser.parse_args(argv)

    from ..train.trainer import load_trained
    from .generate import generate_text

    params, margs, tok, _ = load_trained(a.run, runs_root=a.runs_root,
                                         device=a.device)

    def gen(context: str) -> str:
        return generate_text(params, margs, tok, context,
                             max_new_tokens=a.max_tokens, temperature=a.temperature)

    final, trace = run_agent(gen, a.prompt, max_turns=a.max_turns)
    for i, step in enumerate(trace):
        if step.tool:
            print(f"[turn {i}] {step.tool}({step.args}) -> {step.result}")
    print(final)
    return final


if __name__ == "__main__":
    main()
