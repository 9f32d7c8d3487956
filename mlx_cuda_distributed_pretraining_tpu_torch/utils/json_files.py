"""Atomic JSON files: the write-then-rename and tolerant read that the JAX
package's ``parallel/elastic.py`` uses for membership stamps (the serving
fleet's ``gen_<g>_p<i>.json`` files are written and read by both packages,
so the bytes match: ``sort_keys=True``, no indent)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


def atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    """Write ``obj`` to a temporary file beside ``path``, fsync it, then
    rename it over ``path``: a reader sees the old file or the new one,
    never a torn one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Dict[str, Any]]:
    """The JSON object in ``path``, or None when the file is missing,
    unreadable, torn or not an object."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            obj = json.load(f)
        return obj if isinstance(obj, dict) else None
    except (OSError, json.JSONDecodeError, ValueError):
        return None
