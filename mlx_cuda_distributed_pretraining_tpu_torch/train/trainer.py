"""Loading a trained run for serving (the trainer itself is not ported yet).

A run directory written by the JAX trainer holds ``config.yaml``, the
tokenizer under ``tokenizer/`` and ``checkpoints/step_<tag>_model.safetensors``
files; :func:`load_trained` reads them into the port's parameters.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ..config import Config
from ..models.llama import LlamaArgs
from ..tokenizer import TokenizerManager


def _step_sort_key(tag: str) -> Tuple[int, int]:
    """Newest first: "final" outranks any numeric step, numeric steps
    descend, unknown tags come last."""
    if tag == "final":
        return (0, 0)
    if tag.isdigit():
        return (1, -int(tag))
    return (2, 0)


def latest_model_path(run_dir: str) -> Optional[str]:
    """Path of the newest ``step_<tag>_model.safetensors`` under
    ``run_dir/checkpoints`` (None when there is none). Integrity manifests
    are not verified here."""
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    prefix, suffix = "step_", "_model.safetensors"
    tags = [f[len(prefix):-len(suffix)] for f in os.listdir(ckpt_dir)
            if f.startswith(prefix) and f.endswith(suffix)]
    if not tags:
        return None
    tag = min(tags, key=_step_sort_key)
    return os.path.join(ckpt_dir, f"{prefix}{tag}{suffix}")


def load_trained(run_name_or_dir: str, runs_root: str = "runs", device="cuda"):
    """Load a finished run for inference: ``(params, args, tokenizer,
    config)`` with params on ``device``."""
    from ..checkpoint.safetensors_io import load_safetensors
    from ..convert import params_from_flat

    run_dir = (run_name_or_dir if os.path.isdir(run_name_or_dir)
               else os.path.join(runs_root, run_name_or_dir))
    cfg = Config.from_yaml(os.path.join(run_dir, "config.yaml"))
    tok = TokenizerManager.from_run_dir(run_dir)
    args = LlamaArgs.from_config(cfg.model, tok.vocab_size)
    model_path = latest_model_path(run_dir)
    if model_path is None:
        raise FileNotFoundError(f"no model checkpoints in {run_dir}")
    arrays, _ = load_safetensors(model_path)
    return params_from_flat(arrays, device), args, tok, cfg
