"""Build the port's CUDA sources into shared libraries with ``nvcc``.

Each ``csrc/*.cu`` has a plain-C interface and no PyTorch headers, so one
``nvcc`` call per source builds it in seconds. The library lands in
``build/kernels/`` at the repository root (git-ignored) under a name that
carries a hash of the source and of every header in ``csrc/`` (``*.cuh``):
an edited kernel or header rebuilds, an unchanged one is reused. The
compiler's ``-Xptxas -v`` report is kept beside it as ``.log``.
:func:`build_libraries` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_SECONDS: Dict[str, float] = {}


def library_path(src: Path) -> Path:
    """Where ``src`` builds to: the name hashes the source together with
    every ``*.cuh`` beside it, since any source may include any header."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from csrc/ at first use")
    return nvcc


def build_libraries(srcs: Sequence[Path]) -> List[Path]:
    """Compile every source not built yet for sm_90a, all at once, and
    return the libraries' paths in the order of ``srcs``. Each build's wall
    seconds land in :data:`BUILD_SECONDS` under the source's name."""
    outs = [library_path(src) for src in srcs]
    todo = [(src, out) for src, out in zip(srcs, outs) if not out.exists()]
    if not todo:
        return outs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    running = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(src)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        running.append((src, out, tmp, log, proc))
    failed = []
    while running:
        time.sleep(0.05)
        for item in [r for r in running if r[4].poll() is not None]:
            running.remove(item)
            src, out, tmp, log, proc = item
            BUILD_SECONDS[src.name] = time.perf_counter() - start
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{log.read_text()}")
            else:
                os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return outs


def build_library(src: Path) -> Path:
    return build_libraries([src])[0]
