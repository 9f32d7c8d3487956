"""Model FLOPs accounting and MFU (the JAX package's ``obs/flops.py``).

PaLM appendix-B convention: a training step needs ``6 * N`` FLOPs per token
for the matmuls plus ``6 * num_layers * seq * d_attn`` for the attention
score and value products, and

    MFU = flops_per_token * tokens_per_second / (peak_flops_per_chip * n_chips)

with the card's dense bf16 peak. An MoE model is costed on the parameters a
token multiplies against (the router, its top-k experts and every shared
weight), not on all E experts.

:class:`GoodputLedger` splits each log window's wall clock into where it
went (the JAX package's, booked the same way by the trainer).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# bf16 dense peak FLOP/s per card, keyed by device-name substring (NVIDIA's
# H100 SXM data sheet).
_PEAK_BY_KIND = (("h100", 989e12),)


def flops_per_token(n_params: int, num_layers: int, seq_len: int,
                    d_attn: int) -> float:
    """Analytic train-step FLOPs per token: 6N matmul + attention term."""
    return 6.0 * float(n_params) + 6.0 * float(num_layers) * float(seq_len) * float(d_attn)


def moe_active_params(n_params: int, num_layers: int, hidden_size: int,
                      intermediate_size: int, num_experts: int,
                      experts_per_tok: int) -> int:
    """``n_params`` less the (E - K) inactive experts' three SwiGLU matrices
    in every layer."""
    if num_experts <= 0 or experts_per_tok <= 0 or experts_per_tok >= num_experts:
        return int(n_params)
    per_expert = 3 * int(hidden_size) * int(intermediate_size)
    inactive = int(num_layers) * (int(num_experts) - int(experts_per_tok)) * per_expert
    return int(n_params) - inactive


def model_flops_per_token(model_cfg: Any, n_params: int, seq_len: int) -> float:
    """FLOPs/token from the model config and the exact param count (an MoE
    config's ``moe`` section costs it on active params)."""
    d_attn = int(model_cfg.num_heads) * int(model_cfg.head_dim)
    moe = dict(getattr(model_cfg, "moe", None) or {})
    n_active = int(n_params)
    if int(moe.get("num_local_experts", 0) or 0) > 0:
        n_active = moe_active_params(
            n_params, int(model_cfg.num_layers), int(model_cfg.hidden_size),
            int(model_cfg.intermediate_size),
            int(moe.get("num_local_experts", 0) or 0),
            int(moe.get("num_experts_per_tok", 0) or 0))
    return flops_per_token(n_active, int(model_cfg.num_layers), int(seq_len), d_attn)


def peak_flops_per_chip(device_kind: str) -> Optional[float]:
    """bf16 peak FLOP/s of the card ``device_kind`` names
    (``torch.cuda.get_device_name``), or None when the table lacks it."""
    kind = str(device_kind).lower()
    for needle, peak in _PEAK_BY_KIND:
        if needle in kind:
            return peak
    return None


def mfu(tok_s: float, flops_per_tok: float, peak_per_chip: Optional[float],
        n_chips: int) -> Optional[float]:
    """Model FLOPs utilization, or None when the peak is unknown."""
    if peak_per_chip is None or peak_per_chip <= 0 or n_chips <= 0:
        return None
    return float(flops_per_tok) * float(tok_s) / (peak_per_chip * n_chips)


# Goodput components in reporting order. ``other_s`` is the residual and
# is appended by close_window, never booked directly.
GOODPUT_COMPONENTS = (
    "compile_s", "data_wait_s", "h2d_wait_s", "dispatch_s",
    "ckpt_save_s", "eval_s", "restart_lost_s",
)


class GoodputLedger:
    """Window and cumulative attribution of wall-clock seconds.

    ``add(component, seconds)`` books time into the current window;
    ``close_window(elapsed_s)`` returns the window's breakdown with the
    residual ``other_s = max(0, elapsed - sum(booked))`` appended, folds it
    into the cumulative totals and resets the window. The components
    therefore sum to the window's wall time (up to clamping when booked
    time exceeds it: overlapping attributions).
    """

    def __init__(self):
        self._window: Dict[str, float] = {c: 0.0 for c in GOODPUT_COMPONENTS}
        self._total: Dict[str, float] = {c: 0.0 for c in GOODPUT_COMPONENTS}
        self._total["other_s"] = 0.0

    def add(self, component: str, seconds: float) -> None:
        if component not in self._window:
            raise KeyError(f"unknown goodput component: {component!r} "
                           f"(one of {GOODPUT_COMPONENTS})")
        self._window[component] += max(0.0, float(seconds))

    def window_view(self) -> Dict[str, float]:
        return dict(self._window)

    def close_window(self, elapsed_s: float) -> Dict[str, float]:
        booked = sum(self._window.values())
        out = dict(self._window)
        out["other_s"] = max(0.0, float(elapsed_s) - booked)
        for c, v in out.items():
            self._total[c] += v
        self._window = {c: 0.0 for c in GOODPUT_COMPONENTS}
        return out

    def totals(self) -> Dict[str, float]:
        return dict(self._total)
