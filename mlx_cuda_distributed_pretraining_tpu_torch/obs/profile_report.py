"""Step-time attribution from a ``torch.profiler`` Chrome trace (the JAX
package's ``obs/profile_report.py``, reading what ``torch.profiler``
exports instead of a ``jax.profiler`` dump).

Each training step's wall time is split into:

  compute   union of device op intervals classified as compute, split into
            families: matmul (cuBLAS / CUTLASS GEMMs), flash (the port's
            flash kernels), gmm (its grouped GEMMs: gmm, tgmm, gmm_int8),
            other
  comm      collectives (NCCL kernels) by kind; the headline ``comm_frac``
            counts only EXPOSED comm (not hidden under compute)
  host      host transfers (``Memcpy HtoD`` / ``DtoH``)
  idle      step duration not covered by any device op

plus an **overlap fraction**: the share of collective time that ran
concurrently with compute. By construction, per step::

    compute_frac + comm_frac + host_frac + idle_frac == 1.0

Device ops are the trace's CUDA kernels, memcpys and memsets; a trace that
holds none (a CPU run) attributes its ``cpu_op`` events instead, so the
report reads on the CPU too. Device identity is ``(file, pid)``: one GPU's
streams share a lane.

Steps come from ``ProfilerStep#N`` (``torch.profiler``'s ``step()``) or
``TrainStep#N`` (the trainer's ``record_function`` around each step), or
from ``args.step_num``. A step runs on the device after its host marker:
each step's window is its marker extended to the end of the device ops
its launches started (matched by ``args.correlation``). A trace with no
step marker is attributed as one synthetic step spanning its device ops.
Files are read torn-tail tolerant (a crash mid-dump loses the tail events,
never the report).

The optional ``analytic`` join turns time shares into achieved rates:
matmul/flash families get achieved FLOP/s against the analytic cost
(``obs/flops.py``).
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

REPORT_VERSION = 1
SUMMARY_FILENAME = "prof_summary.json"

# Fraction gauge / event-field names, in reporting order.
PROF_FIELDS = ("prof_compute_frac", "prof_comm_frac",
               "prof_overlap_frac", "prof_idle_frac")

# Collective op-name prefixes (XLA's names, kept so both packages classify
# them alike; ``-start`` async variants match by prefix, ``-done`` waits
# fold into the same kind).
COMM_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "ragged-all-to-all", "collective-permute", "collective-broadcast",
    "send", "recv",
)
# NCCL kernel names (ncclDevKernel_AllReduce_Sum_f32_RING_LL, ...) by kind
_NCCL_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
               ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
               ("broadcast", "collective-broadcast"), ("sendrecv", "send"),
               ("send", "send"), ("recv", "recv"))
# GEMM kernels of cuBLAS (sm90_xmma_gemm_*, nvjet_*), CUTLASS, and the
# matrix products of a CPU run
_MATMUL_MARKS = ("nvjet", "cutlass", "xmma", "aten::mm", "aten::addmm",
                 "aten::bmm", "aten::linear")

_NUM_SUFFIX = re.compile(r"[._]\d+$")
_DONE_SUFFIX = re.compile(r"-done$")
_STEP_NAME = re.compile(r"^(?:ProfilerStep|TrainStep)#(\d+)$")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def base_op_name(name: str) -> str:
    """The stable op identity the table aggregates on: a CUDA kernel's
    signature ``void (anonymous namespace)::gmm_bf16_wgmma_kernel<2, 128,
    4, false>(...)`` reads ``gmm_bf16_wgmma_kernel`` (its template
    instances share a row); then,
    as in JAX, ``%all-gather-start.12`` reads ``all-gather-start``."""
    base = str(name).strip()
    if "(" in base or "<" in base:
        base = base.replace("(anonymous namespace)::", "")
        if base.startswith("void "):
            base = base[len("void "):]
        base = re.split(r"[<(]", base, 1)[0].strip()
    base = base.lstrip("%").lower()
    while True:
        stripped = _NUM_SUFFIX.sub("", base)
        if stripped == base:
            return base
        base = stripped


def classify_op(name: str) -> Tuple[str, str]:
    """(category, family) for one op name.

    category in {compute, comm, host}; family is the compute family
    (matmul/flash/gmm/other) or the collective kind or "host". The JAX
    package's rules come first, so an XLA op name lands where it does
    there; the CUDA kernel names of the port, cuBLAS, CUTLASS and NCCL
    and the CUDA memcpys are classified beside them.
    """
    base = base_op_name(name)
    kind = _DONE_SUFFIX.sub("", base)
    for k in COMM_KINDS:
        if kind == k or kind.startswith(k + "-"):
            return "comm", k
    if base.startswith("nccl"):
        squashed = base.replace("_", "")
        for mark, k in _NCCL_KINDS:
            if mark in squashed:
                return "comm", k
        return "comm", "nccl"
    if base.startswith(("infeed", "outfeed")) or "host-transfer" in base \
            or base.startswith(("memcpy htod", "memcpy dtoh")):
        return "host", "host"
    if base.startswith(("dot", "convolution")) or "gemm" in base \
            or "matmul" in base or any(m in base for m in _MATMUL_MARKS):
        return "compute", "matmul"
    if "flash" in base or "attention" in base:
        return "compute", "flash"
    if "gmm" in base or "megablox" in base or "grouped" in base:
        return "compute", "gmm"
    return "compute", "other"


# -- trace file discovery -------------------------------------------------


def find_trace_files(path: str) -> List[str]:
    """Trace files for a dump dir, run dir, session dir, or direct file.

    A run dir contains ``profile/``; a dump dir contains
    ``plugins/profile/<session>/`` (the layout :class:`.profiler.ProfileCapture`
    writes); only the NEWEST session is used (a run that captured twice
    reports the latest window).
    """
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        return []
    roots = [path]
    sub = os.path.join(path, "profile")
    if os.path.isdir(sub):
        roots.append(sub)
    for root in roots:
        sessions = sorted(glob.glob(os.path.join(root, "plugins", "profile", "*")))
        sessions = [s for s in sessions if os.path.isdir(s)]
        if sessions:
            newest = max(sessions, key=os.path.getmtime)
            files = sorted(glob.glob(os.path.join(newest, "*.trace.json.gz"))
                           + glob.glob(os.path.join(newest, "*.trace.json")))
            if files:
                return files
        files = sorted(glob.glob(os.path.join(root, "*.trace.json.gz"))
                       + glob.glob(os.path.join(root, "*.trace.json")))
        if files:
            return files
    return []


def _read_text(path: str) -> str:
    """Read a trace file, tolerating a torn gzip tail: whatever
    decompressed cleanly is returned."""
    if path.endswith(".gz"):
        chunks: List[bytes] = []
        try:
            with gzip.open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    chunks.append(chunk)
        except (EOFError, OSError, gzip.BadGzipFile):
            pass  # keep the prefix that decompressed
        return b"".join(chunks).decode("utf-8", errors="replace")
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return f.read()


def load_trace_events(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """(events, torn). A file that parses whole is not torn; otherwise
    complete event objects are salvaged from the ``traceEvents`` array one
    ``raw_decode`` at a time and the file is flagged torn."""
    text = _read_text(path)
    try:
        doc = json.loads(text)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        return [e for e in events if isinstance(e, dict)], False
    except json.JSONDecodeError:
        pass
    start = text.find('"traceEvents"')
    if start >= 0:
        start = text.find("[", start)
    elif text.lstrip().startswith("["):
        start = text.find("[")
    if start < 0:
        return [], True
    dec = json.JSONDecoder()
    events = []
    i = start + 1
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] != "{":
            break
        try:
            obj, end = dec.raw_decode(text, i)
        except json.JSONDecodeError:
            break
        if isinstance(obj, dict):
            events.append(obj)
        i = end
    return events, True


# -- interval sweep -------------------------------------------------------


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not iv:
        return []
    iv = sorted(iv)
    out = [iv[0]]
    for s, e in iv[1:]:
        ls, le = out[-1]
        if s <= le:
            out[-1] = (ls, max(le, e))
        else:
            out.append((s, e))
    return out


def _total(merged: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _clip(iv: List[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in iv
            if max(s, lo) < min(e, hi)]


# -- attribution ----------------------------------------------------------


def _step_of(ev: Dict[str, Any]) -> Optional[int]:
    """The step an X event marks, or None."""
    args = ev.get("args") or {}
    if "step_num" in args:
        try:
            return int(args["step_num"])
        except (TypeError, ValueError):
            return None
    m = _STEP_NAME.match(str(ev.get("name", "")))
    return int(m.group(1)) if m else None


def _collect(trace_files: List[str]):
    """Flatten files into (device ops, step windows, torn_any): see the
    module docstring for what counts as a device op and a step."""
    ops: List[Dict[str, Any]] = []
    step_bounds: Dict[int, Tuple[float, float]] = {}
    torn_any = False
    for idx, path in enumerate(trace_files):
        events, torn = load_trace_events(path)
        torn_any = torn_any or torn
        xs = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            try:
                ts = float(ev.get("ts", 0.0))
                dur = float(ev.get("dur", 0.0))
            except (TypeError, ValueError):
                continue
            xs.append((ev, ts, dur))
        has_device = any(ev.get("cat") in _DEVICE_CATS for ev, _, _ in xs)
        device_cats = _DEVICE_CATS if has_device else ("cpu_op",)
        markers: List[Tuple[float, float, int]] = []
        launches: Dict[Any, float] = {}  # correlation -> host launch time
        file_ops: List[Dict[str, Any]] = []
        for ev, ts, dur in xs:
            step = _step_of(ev)
            if step is not None:
                lo, hi = step_bounds.get(step, (ts, ts + dur))
                step_bounds[step] = (min(lo, ts), max(hi, ts + dur))
                markers.append((ts, ts + dur, step))
                continue
            args = ev.get("args") or {}
            if ev.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                launches[args["correlation"]] = ts
                continue
            if dur <= 0 or ev.get("cat") not in device_cats:
                continue
            name = str(ev.get("name") or "?")
            cat, fam = classify_op(name)
            file_ops.append({"name": base_op_name(name), "cat": cat,
                             "fam": fam, "ts": ts, "end": ts + dur,
                             "dur": dur, "dev": (idx, ev.get("pid")),
                             "corr": args.get("correlation")})
        # A step runs on the device after its marker: extend each step's
        # window to the end of the device ops its launches started.
        markers.sort()
        starts = [m[0] for m in markers]
        for o in file_ops:
            t = launches.get(o["corr"]) if o["corr"] is not None else None
            if t is None or not markers:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and markers[i][0] <= t <= markers[i][1]:
                step = markers[i][2]
                lo, hi = step_bounds[step]
                step_bounds[step] = (lo, max(hi, o["end"]))
        for o in file_ops:
            del o["corr"]
        ops.extend(file_ops)
    return ops, step_bounds, torn_any


def attribute(trace_files: List[str],
              analytic: Optional[Dict[str, Any]] = None,
              top_k: int = 12) -> Optional[Dict[str, Any]]:
    """Parse + attribute. Returns the report dict, or None when the files
    contain no device ops at all (nothing to attribute)."""
    ops, step_bounds, torn = _collect(trace_files)
    if not ops:
        return None
    if not step_bounds:
        step_bounds = {0: (min(o["ts"] for o in ops),
                           max(o["end"] for o in ops))}
    devices = sorted({o["dev"] for o in ops}, key=lambda d: (d[0], str(d[1])))
    by_dev: Dict[Any, List[Dict[str, Any]]] = {d: [] for d in devices}
    for o in ops:
        by_dev[o["dev"]].append(o)

    steps: List[Dict[str, Any]] = []
    for step in sorted(step_bounds):
        lo, hi = step_bounds[step]
        dur_us = hi - lo
        if dur_us <= 0:
            continue
        acc = {k: 0.0 for k in ("compute", "comm", "comm_exposed",
                                "host", "idle", "overlap", "busy")}
        fam_us: Dict[str, float] = {}
        kind_us: Dict[str, float] = {}
        for dev in devices:
            comp_iv, comm_iv, host_iv = [], [], []
            for o in by_dev[dev]:
                s, e = max(o["ts"], lo), min(o["end"], hi)
                if s >= e:
                    continue
                if o["cat"] == "comm":
                    comm_iv.append((s, e))
                    kind_us[o["fam"]] = kind_us.get(o["fam"], 0.0) + (e - s)
                elif o["cat"] == "host":
                    host_iv.append((s, e))
                else:
                    comp_iv.append((s, e))
                    fam_us[o["fam"]] = fam_us.get(o["fam"], 0.0) + (e - s)
            comp = _merge(comp_iv)
            comm = _merge(comm_iv)
            both = _merge(comp + comm)
            busy = _merge(comp + comm + host_iv)
            compute_s = _total(comp)
            comm_s = _total(comm)
            overlap_s = _total(_intersect(comp, comm))
            acc["compute"] += compute_s
            acc["comm"] += comm_s
            acc["overlap"] += overlap_s
            acc["comm_exposed"] += comm_s - overlap_s
            acc["host"] += _total(busy) - _total(both)
            acc["busy"] += _total(busy)
            acc["idle"] += dur_us - _total(busy)
        nd = len(devices)
        denom = dur_us * nd
        steps.append({
            "step": step,
            "dur_s": round(dur_us / 1e6, 6),
            "compute_s": round(acc["compute"] / nd / 1e6, 6),
            "comm_s": round(acc["comm"] / nd / 1e6, 6),
            "comm_exposed_s": round(acc["comm_exposed"] / nd / 1e6, 6),
            "host_s": round(acc["host"] / nd / 1e6, 6),
            "idle_s": round(acc["idle"] / nd / 1e6, 6),
            "overlap_s": round(acc["overlap"] / nd / 1e6, 6),
            "compute_frac": acc["compute"] / denom,
            "comm_frac": acc["comm_exposed"] / denom,
            "comm_total_frac": acc["comm"] / denom,
            "host_frac": acc["host"] / denom,
            "idle_frac": acc["idle"] / denom,
            "overlap_frac": (acc["overlap"] / acc["comm"]
                             if acc["comm"] > 0 else 0.0),
            "compute_by_family": {k: round(v / nd / 1e6, 6)
                                  for k, v in sorted(fam_us.items())},
            "comm_by_kind": {k: round(v / nd / 1e6, 6)
                             for k, v in sorted(kind_us.items())},
        })
    if not steps:
        return None

    # Duration-weighted aggregate from the UNROUNDED per-step fractions, so
    # compute + comm + host + idle still sums to 1 here.
    tot_dur = sum(s["dur_s"] for s in steps)
    agg: Dict[str, Any] = {"n_steps": len(steps),
                           "dur_s": round(tot_dur, 6)}
    for key in ("compute", "comm", "comm_exposed", "host", "idle",
                "overlap"):
        agg[key + "_s"] = round(sum(s[key + "_s"] for s in steps), 6)
    wsum = sum(s["dur_s"] for s in steps)
    for frac in ("compute_frac", "comm_frac", "comm_total_frac",
                 "host_frac", "idle_frac"):
        agg[frac] = sum(s[frac] * s["dur_s"] for s in steps) / wsum
    comm_w = sum(s["comm_total_frac"] * s["dur_s"] for s in steps)
    agg["overlap_frac"] = (
        sum(s["overlap_frac"] * s["comm_total_frac"] * s["dur_s"]
            for s in steps) / comm_w if comm_w > 0 else 0.0)

    report = {
        "version": REPORT_VERSION,
        "trace_files": [os.path.basename(p) for p in trace_files],
        "torn": torn,
        "n_devices": len(devices),
        "steps": steps,
        "aggregate": agg,
        "ops": _op_table(ops, step_bounds, len(devices), top_k),
        "families": _family_table(steps, analytic),
    }
    if analytic:
        report["analytic"] = {k: v for k, v in analytic.items()
                              if isinstance(v, (int, float, dict))}
    return report


def _op_table(ops, step_bounds, n_devices: int,
              top_k: int) -> List[Dict[str, Any]]:
    """Top-k ops by total time inside the step windows, with their share
    of step wall time per device."""
    windows = _merge(list(step_bounds.values()))
    tot_dur_us = _total(windows)
    by_name: Dict[str, Dict[str, Any]] = {}
    for o in ops:
        clipped = _total(_clip([(o["ts"], o["end"])], windows[0][0],
                               windows[-1][1])) if windows else o["dur"]
        if clipped <= 0:
            continue
        row = by_name.setdefault(o["name"], {
            "op": o["name"], "family": o["fam"], "category": o["cat"],
            "count": 0, "total_us": 0.0})
        row["count"] += 1
        row["total_us"] += clipped
    rows = sorted(by_name.values(), key=lambda r: -r["total_us"])[:top_k]
    out = []
    for r in rows:
        out.append({
            "op": r["op"], "family": r["family"],
            "category": r["category"], "count": r["count"],
            "total_s": round(r["total_us"] / 1e6, 6),
            "mean_us": round(r["total_us"] / r["count"], 2),
            "frac": (round(r["total_us"] / (tot_dur_us * n_devices), 6)
                     if tot_dur_us > 0 else 0.0),
        })
    return out


def _family_table(steps, analytic) -> Dict[str, Any]:
    """Per-family totals with achieved-vs-analytic joins: FLOP/s for the
    matmul/flash compute families, bytes/s for collective kinds (when the
    analytic dict carries ``collective_bytes_per_step``)."""
    fam_s: Dict[str, float] = {}
    kind_s: Dict[str, float] = {}
    for st in steps:
        for k, v in st["compute_by_family"].items():
            fam_s[k] = fam_s.get(k, 0.0) + v
        for k, v in st["comm_by_kind"].items():
            kind_s[k] = kind_s.get(k, 0.0) + v
    n_steps = len(steps)
    an = analytic or {}
    toks = float(an.get("tokens_per_step") or 0.0)
    fam_flops = {
        "matmul": float(an.get("matmul_flops_per_token") or 0.0) * toks,
        "flash": float(an.get("attn_flops_per_token") or 0.0) * toks,
    }
    out: Dict[str, Any] = {"compute": {}, "comm": {}}
    for fam, secs in sorted(fam_s.items()):
        row: Dict[str, Any] = {"total_s": round(secs, 6)}
        flops_step = fam_flops.get(fam, 0.0)
        if flops_step > 0 and secs > 0:
            row["analytic_flops_per_step"] = flops_step
            row["achieved_flops_per_s"] = round(flops_step * n_steps / secs, 3)
        out["compute"][fam] = row
    bytes_by_kind = dict(an.get("collective_bytes_per_step") or {})
    for kind, secs in sorted(kind_s.items()):
        row = {"total_s": round(secs, 6)}
        b = float(bytes_by_kind.get(kind) or 0.0)
        if b > 0 and secs > 0:
            row["bytes_per_step"] = b
            row["achieved_bytes_per_s"] = round(b * n_steps / secs, 3)
        out["comm"][kind] = row
    return out


# -- entry points ---------------------------------------------------------


def generate_report(dump_or_file: str,
                    analytic: Optional[Dict[str, Any]] = None,
                    top_k: int = 12) -> Optional[Dict[str, Any]]:
    """Find trace files under ``dump_or_file`` and attribute them.
    Returns None when no trace files (or no device ops) are found."""
    files = find_trace_files(dump_or_file)
    if not files:
        return None
    report = attribute(files, analytic=analytic, top_k=top_k)
    if report is not None:
        report["dump"] = os.path.abspath(dump_or_file)
    return report


def prof_fields(report: Dict[str, Any], digits: int = 4) -> Dict[str, float]:
    """The four headline fractions under their gauge / event-field names
    (PROF_FIELDS)."""
    agg = report["aggregate"]
    return {
        "prof_compute_frac": round(agg["compute_frac"], digits),
        "prof_comm_frac": round(agg["comm_frac"], digits),
        "prof_overlap_frac": round(agg["overlap_frac"], digits),
        "prof_idle_frac": round(agg["idle_frac"], digits),
    }


def write_summary(report: Dict[str, Any], path: str) -> str:
    """Atomic JSON summary write (temp + rename: readers never see a torn
    summary)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
