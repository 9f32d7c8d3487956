"""Compact per-series append-only time-series storage for the scope
collector (the JAX package's ``obs/tsdb.py``: the files are byte for byte
the same, and either package reads the other's).

The collector (obs/scope.py) scrapes every fleet member's ``/metrics``
endpoint on an interval and needs *history* — burn-rate alerting compares
a fast window against a slow one, z-score anomaly detection needs a
trailing baseline — but a full TSDB dependency is off the table (obs/ is
stdlib-only by charter).  This module is the minimal durable middle:

  * One append-only file per series under ``dir/``, named by a short
    blake2b digest of the series key ``name{k=v,...}``.  The first line
    is a JSON header carrying the key in clear text (so files remain
    self-describing); every record after it is binary.
  * Records are delta-of-delta encoded timestamps (milliseconds, zigzag
    varint) plus a value encoding that stores counter-style deltas as
    zigzag varints when they are exactly representable at millis
    precision and falls back to a raw little-endian float64 otherwise.
    A steady counter scraped every few seconds costs ~3 bytes/sample.
  * Torn tails are tolerated exactly like events.jsonl: a reader stops
    at the first truncated record instead of raising, so a crash mid-
    append never poisons history.
  * Retention is capped per series (``max_points``); compaction rewrites
    the file keeping the newest points once it grows past 2x the cap.

Readers get a small query API: raw ranges, counter-reset-aware
``rate()``/``increase()``, ``latest()``, and histogram quantiles rebuilt
from ``_bucket`` series via obs/metrics.quantile_from_buckets — the same
estimator the serve engine uses, so the collector's p99 agrees with the
engine's own.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import struct
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .metrics import quantile_from_buckets

HEADER_VERSION = 1

# Value records: counter deltas that survive a round-trip through a
# 1/1000 fixed-point grid are stored as varints; everything else is a raw
# float64.  The tag byte keeps the format self-delimiting.
_VAL_VARINT = 0
_VAL_FLOAT64 = 1

_SCALE = 1000.0


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical series key: ``name{k=v,...}`` with sorted label keys."""
    if not labels:
        return name
    inner = ",".join("%s=%s" % (k, labels[k]) for k in sorted(labels))
    return "%s{%s}" % (name, inner)


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`series_key` (labels never contain ``{``/``=``)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    rest = rest.rstrip("}")
    labels: Dict[str, str] = {}
    if rest:
        for part in rest.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_varint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """Returns (value, next_pos); raises ValueError on a torn varint."""
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("torn varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


def encode_record(t_ms: int, prev_t_ms: int, prev_delta_ms: int,
                  value: float, prev_value: float) -> bytes:
    """Encode one sample relative to the previous one."""
    buf = bytearray()
    delta = t_ms - prev_t_ms
    _write_varint(buf, _zigzag(delta - prev_delta_ms))
    if math.isfinite(value) and math.isfinite(prev_value):
        scaled = round((value - prev_value) * _SCALE)
        if abs(scaled) < (1 << 53) and prev_value + scaled / _SCALE == value:
            buf.append(_VAL_VARINT)
            _write_varint(buf, _zigzag(scaled))
            return bytes(buf)
    buf.append(_VAL_FLOAT64)
    buf += struct.pack("<d", value)
    return bytes(buf)


def decode_records(data: bytes) -> List[Tuple[int, float]]:
    """Decode a record stream; stops silently at the first torn record."""
    return _decode_records_pos(data)[0]


def _decode_records_pos(data: bytes) -> Tuple[List[Tuple[int, float]], int]:
    """Like :func:`decode_records` but also returns bytes consumed, so a
    loader can truncate a torn tail before appending fresh records."""
    out: List[Tuple[int, float]] = []
    pos = 0
    t_ms = 0
    delta = 0
    value = 0.0
    good = 0
    while pos < len(data):
        try:
            dod, pos = _read_varint(data, pos)
            delta += _unzigzag(dod)
            t_ms += delta
            if pos >= len(data):
                raise ValueError("torn tag")
            tag = data[pos]
            pos += 1
            if tag == _VAL_VARINT:
                dv, pos = _read_varint(data, pos)
                value = value + _unzigzag(dv) / _SCALE
            elif tag == _VAL_FLOAT64:
                if pos + 8 > len(data):
                    raise ValueError("torn float")
                (value,) = struct.unpack_from("<d", data, pos)
                pos += 8
            else:
                raise ValueError("bad tag %d" % tag)
        except ValueError:
            break
        out.append((t_ms, value))
        good = pos
    return out, good


class _Series:
    """In-memory head state + file handle for one series.

    Owned by the TSDB; all mutation happens under the TSDB lock.
    """

    __slots__ = ("key", "path", "points", "prev_t_ms", "prev_delta_ms",
                 "prev_value", "file_bytes")

    def __init__(self, key: str, path: str) -> None:
        self.key = key
        self.path = path
        self.points: List[Tuple[int, float]] = []
        self.prev_t_ms = 0
        self.prev_delta_ms = 0
        self.prev_value = 0.0
        self.file_bytes = 0


class TSDB:
    """Append-only on-disk sample store with bounded retention.

    ``dir`` may be None for a purely in-memory store (tests, short-lived
    collectors); everything else behaves identically.
    """

    def __init__(self, dir: Optional[str] = None,
                 max_points: int = 4096) -> None:
        self._dir = dir
        self._max_points = max(16, int(max_points))
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}  # guarded by self._lock
        if dir:
            os.makedirs(dir, exist_ok=True)
            with self._lock:
                self._load()

    # ------------------------------------------------------------- load

    def _path_for(self, key: str) -> str:
        digest = hashlib.blake2b(key.encode("utf-8"), digest_size=8).hexdigest()
        return os.path.join(self._dir or "", "%s.gts" % digest)

    def _load(self) -> None:
        for fname in sorted(os.listdir(self._dir or ".")):
            if not fname.endswith(".gts"):
                continue
            path = os.path.join(self._dir or "", fname)
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError:
                continue
            nl = raw.find(b"\n")
            if nl < 0:
                continue
            try:
                header = json.loads(raw[:nl].decode("utf-8"))
                key = header["key"]
            except (ValueError, KeyError):
                continue
            s = _Series(key, path)
            body = raw[nl + 1:]
            s.points, consumed = _decode_records_pos(body)
            if consumed < len(body):
                # Torn tail from a crash mid-append: drop the partial
                # record so fresh appends stay decodable.
                try:
                    with open(path, "r+b") as fh:
                        fh.truncate(nl + 1 + consumed)
                    raw = raw[:nl + 1 + consumed]
                except OSError:
                    continue
            s.file_bytes = len(raw)
            if s.points:
                s.prev_t_ms = s.points[-1][0]
                s.prev_value = s.points[-1][1]
                # The decoder's running delta after sample 1 is t1 - 0, so
                # a single-sample series resumes with delta = t1.
                s.prev_delta_ms = (s.points[-1][0] - s.points[-2][0]
                                   if len(s.points) > 1 else s.points[-1][0])
            self._series[key] = s

    # ----------------------------------------------------------- append

    def append(self, name: str, labels: Optional[Dict[str, str]],
               t_s: float, value: float) -> None:
        """Record one sample at wall time ``t_s`` (seconds)."""
        key = series_key(name, labels)
        t_ms = int(t_s * 1000.0)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(key, self._path_for(key) if self._dir else "")
                self._series[key] = s
                if self._dir:
                    header = json.dumps({"v": HEADER_VERSION, "key": key},
                                        sort_keys=True)
                    with open(s.path, "wb") as fh:
                        fh.write(header.encode("utf-8") + b"\n")
                    s.file_bytes = len(header) + 1
            if s.points and t_ms <= s.prev_t_ms:
                # Monotonic per series: a replayed or clock-skewed sample
                # is dropped rather than corrupting the dod chain.
                return
            rec = encode_record(t_ms, s.prev_t_ms, s.prev_delta_ms,
                                value, s.prev_value)
            if self._dir:
                with open(s.path, "ab") as fh:
                    fh.write(rec)
                s.file_bytes += len(rec)
            s.prev_delta_ms = t_ms - s.prev_t_ms
            s.prev_t_ms = t_ms
            s.prev_value = value
            s.points.append((t_ms, value))
            if len(s.points) > 2 * self._max_points:
                self._compact(s)

    def _compact(self, s: _Series) -> None:
        """Rewrite ``s`` keeping the newest ``max_points`` samples."""
        s.points = s.points[-self._max_points:]
        s.prev_t_ms = 0
        s.prev_delta_ms = 0
        s.prev_value = 0.0
        if not self._dir:
            if s.points:
                s.prev_t_ms = s.points[-1][0]
                s.prev_value = s.points[-1][1]
                s.prev_delta_ms = (s.points[-1][0] - s.points[-2][0]
                                   if len(s.points) > 1 else s.points[-1][0])
            return
        header = json.dumps({"v": HEADER_VERSION, "key": s.key},
                            sort_keys=True).encode("utf-8") + b"\n"
        body = bytearray()
        pt = pd = 0
        pv = 0.0
        for t_ms, value in s.points:
            rec = encode_record(t_ms, pt, pd, value, pv)
            body += rec
            pd = t_ms - pt
            pt = t_ms
            pv = value
        tmp = s.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(header + bytes(body))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, s.path)
        s.file_bytes = len(header) + len(body)
        s.prev_t_ms = pt
        s.prev_delta_ms = pd
        s.prev_value = pv

    # ------------------------------------------------------------ query

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              t0_s: Optional[float] = None,
              t1_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """Samples for one exact series in ``[t0_s, t1_s]`` as (t_s, value)."""
        key = series_key(name, labels)
        lo = int(t0_s * 1000.0) if t0_s is not None else None
        hi = int(t1_s * 1000.0) if t1_s is not None else None
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return []
            out = []
            for t_ms, v in s.points:
                if lo is not None and t_ms < lo:
                    continue
                if hi is not None and t_ms > hi:
                    continue
                out.append((t_ms / 1000.0, v))
            return out

    def select(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> List[str]:
        """Series keys matching ``name`` and a label *subset* filter."""
        want = labels or {}
        out = []
        with self._lock:
            for key in self._series:
                n, ls = parse_series_key(key)
                if n != name:
                    continue
                if all(ls.get(k) == str(v) for k, v in want.items()):
                    out.append(key)
        return sorted(out)

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        pts = self.query(name, labels)
        return pts[-1][1] if pts else None

    def increase(self, name: str, labels: Optional[Dict[str, str]],
                 t0_s: float, t1_s: float) -> float:
        """Counter increase over a window, tolerant of counter resets.

        Sums positive deltas between consecutive samples in the window —
        a restarted process (counter back to 0) contributes its new
        growth instead of a huge negative delta.
        """
        pts = self.query(name, labels, t0_s, t1_s)
        total = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b >= a:
                total += b - a
            else:
                total += b
        return total

    def rate(self, name: str, labels: Optional[Dict[str, str]],
             t0_s: float, t1_s: float) -> float:
        """Per-second counter rate over the window (0 when empty)."""
        span = t1_s - t0_s
        if span <= 0:
            return 0.0
        return self.increase(name, labels, t0_s, t1_s) / span

    def sum_increase(self, name: str, labels: Optional[Dict[str, str]],
                     t0_s: float, t1_s: float) -> float:
        """Increase summed across every series matching the label subset."""
        total = 0.0
        for key in self.select(name, labels):
            _, ls = parse_series_key(key)
            total += self.increase(name, ls, t0_s, t1_s)
        return total

    def quantile(self, name: str, labels: Optional[Dict[str, str]],
                 q: float, t0_s: float, t1_s: float) -> Optional[float]:
        """Quantile of a histogram's ``_bucket`` series over a window.

        Rebuilds the cumulative-bucket shape from per-``le`` counter
        increases and reuses the engine-side estimator so both surfaces
        report the same number for the same window.
        """
        want = dict(labels or {})
        buckets: List[Tuple[float, float]] = []
        inf_cum: Optional[float] = None
        for key in self.select(name + "_bucket", want):
            _, ls = parse_series_key(key)
            le = ls.get("le")
            if le is None:
                continue
            inc = self.increase(name + "_bucket", ls, t0_s, t1_s)
            if le == "+Inf":
                inf_cum = (inf_cum or 0.0) + inc
            else:
                try:
                    buckets.append((float(le), inc))
                except ValueError:
                    continue
        if inf_cum is None:
            return None
        rows: List[List[Any]] = [[le, cum] for le, cum in sorted(buckets)]
        rows.append(["+Inf", inf_cum])
        return quantile_from_buckets(rows, int(inf_cum), q)


def sparkline(values: Iterable[float], width: int = 40) -> str:
    """Terminal sparkline for scope_report (block characters, stdlib)."""
    vals = [v for v in values if isinstance(v, (int, float))
            and math.isfinite(float(v))]
    if not vals:
        return ""
    if len(vals) > width:
        # Downsample by bucketing to the display width, keeping maxima so
        # spikes survive.
        step = len(vals) / float(width)
        vals = [max(vals[int(i * step):max(int(i * step) + 1,
                                           int((i + 1) * step))])
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    blocks = "▁▂▃▄▅▆▇█"
    if hi <= lo:
        return blocks[0] * len(vals)
    span = hi - lo
    return "".join(blocks[min(len(blocks) - 1,
                              int((v - lo) / span * (len(blocks) - 1)))]
                   for v in vals)
