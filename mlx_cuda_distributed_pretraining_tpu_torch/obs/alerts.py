"""Declarative alert rules + state machines for the scope collector (the
JAX package's ``obs/alerts.py``: the same rules over the same samples give
the same transitions).

``configs/alerts.yaml`` declares *what to watch*; this module turns each
rule into a small state machine evaluated against the scope TSDB
(obs/tsdb.py) every collection round.  The grammar is deliberately tiny —
eight rule kinds cover the SLO and training-anomaly alerts — and every
rule is validated up front (``python -m
mlx_cuda_distributed_pretraining_tpu_torch.obs.alerts --validate``) so a
typo'd metric name or a dangling capture action fails before it can
silently never fire.

Rule kinds:

  threshold        latest/avg/min/max of a gauge vs a bound
                   (grad-norm blowup, KV free-block watermark)
  ratio_threshold  numerator metric / denominator metric vs a bound
                   (KV free-block *fraction*, fragmentation)
  error_burn_rate  multi-window burn rate of a bad-outcome counter share
                   (router error ratio vs an availability objective)
  latency_burn_rate  multi-window burn rate of the over-threshold share
                   of a histogram (TTFT p99 objective)
  goodput_floor    share of goodput_seconds_total in good components
  zscore           newest sample vs trailing mean/std (loss spike)
  nonfinite        NaN/Inf sample, or any increase of a *_total sentinel
  baseline_drop    windowed average vs a committed baseline file (bench_baseline.json)
                   (MFU collapse)
  flap             count of value transitions in a window (breaker flaps)

States follow the Prometheus convention: ``inactive`` → ``pending``
(breached, inside the ``for_s`` hold-down) → ``firing`` → back to
``inactive`` (surfaced as a ``resolved`` transition).  Transitions are
returned to the collector, which appends them as ``alert`` events to
events.jsonl and runs the rule's capture actions on fire.
"""

from __future__ import annotations

import json
import math
import statistics
from typing import Any, Dict, List, Optional, Tuple

from .tsdb import TSDB, parse_series_key

# Burn-rate window defaults (Google SRE workbook shape: a fast window to
# catch cliffs, a slow window to suppress blips).
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 300.0

RULE_KINDS = (
    "threshold", "ratio_threshold", "error_burn_rate", "latency_burn_rate",
    "goodput_floor", "zscore", "nonfinite", "baseline_drop", "flap",
)

# Capture hooks the collector knows how to run (obs/scope.py); anything
# else in an ``actions:`` list is a dangling action and fails validation.
ACTIONS = ("trace", "profile", "bundle")

# Catalogue of metric names this tree exports (obs/metrics registries and
# the serve engine's JSON /metrics scalars).  LINT_ALERTS rejects rules
# over names not listed here unless the rule opts out with
# ``custom_metric: true`` — catching typos like serve_ttft_msec at lint
# time instead of silently never alerting.
KNOWN_METRICS = frozenset({
    # training
    "train_steps_total", "train_tokens_total", "train_step", "train_loss",
    "train_tok_s", "train_mfu", "train_grad_norm", "train_nonfinite_total",
    "checkpoint_saves_total", "checkpoint_writes_total",
    "checkpoint_verify_total", "checkpoint_quarantined_total",
    "eval_runs_total", "faults_total", "restarts_total",
    "goodput_seconds_total", "pipeline_bubble_frac",
    "prof_compute_frac", "prof_comm_frac", "prof_overlap_frac",
    "prof_idle_frac",
    "input_batches_total", "input_data_wait_seconds", "input_h2d_seconds",
    "input_queue_depth",
    "moe_balance_entropy", "moe_dropped_tokens_total",
    "moe_expert_load_frac",
    # serving (registry names)
    "serve_requests_total", "serve_iterations_total", "serve_queue_depth",
    "serve_batch_occupancy", "serve_tok_s",
    "serve_ttft_ms", "serve_ttft_component_ms",
    "serve_kv_blocks_used", "serve_kv_blocks_free",
    "serve_kv_free_block_watermark", "serve_kv_fragmentation",
    "serve_kv_transfer_blocks_total", "serve_kv_transfer_failures_total",
    "serve_prefix_cache_hits_total", "serve_prefix_cache_misses_total",
    "serve_prefix_cache_evictions_total", "serve_prefix_cache_hit_rate",
    "serve_spec_tokens_total", "serve_spec_acceptance_rate",
    "serve_weight_bytes", "serve_weight_swaps_total",
    "serve_mesh_devices", "serve_mesh_axis_size",
    "serve_breaker_state", "serve_retry_budget_tokens",
    "serve_faults_injected_total", "serve_policy_retries_total",
    "serve_policy_deadline_exhausted_total",
    "serve_router_requests_total", "serve_router_retries_total",
    "serve_router_replica_up", "serve_router_replica_stale",
    "serve_router_replica_inflight", "serve_router_replica_queue_depth",
    "serve_router_pool_replicas_up", "serve_router_pool_queue_depth",
    "serve_router_pool_kv_blocks_free", "serve_fleet_handoffs_total",
    # serve engine JSON /metrics scalars (scraped verbatim)
    "queue_depth", "batch_occupancy", "num_slots", "iterations",
    "admitted", "rejected", "evicted", "completed", "preempted",
    "kv_blocks_used", "kv_blocks_free", "kv_num_blocks",
    "kv_free_watermark", "kv_fragmentation",
    "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99", "ttft_ms_sum",
    "ttft_ms_count",
    # the scope collector's own metrics (their names are the JAX package's)
    "graftscope_scrape_up", "graftscope_scrape_ms",
    "graftscope_samples_total", "graftscope_scrape_errors_total",
    "graftscope_rounds_total", "graftscope_alerts_firing",
})

_OPS = ("gt", "lt", "ge", "le")


class RuleError(ValueError):
    pass


def _require(rule: Dict[str, Any], field: str, types: tuple,
             errors: List[str], name: str) -> bool:
    if field not in rule:
        errors.append("rule %s: missing required field %r" % (name, field))
        return False
    if not isinstance(rule[field], types):
        errors.append("rule %s: field %r must be %s, got %r"
                      % (name, field, "/".join(t.__name__ for t in types),
                         type(rule[field]).__name__))
        return False
    return True


def _check_window(rule: Dict[str, Any], field: str, errors: List[str],
                  name: str) -> None:
    v = rule.get(field)
    if v is None:
        return
    if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
        errors.append("rule %s: %s must be a positive number, got %r"
                      % (name, field, v))


def validate_rules(doc: Any) -> List[str]:
    """Validate a parsed alerts.yaml document; returns a list of errors.

    An empty list means the config is well-formed.  Checks: structural
    shape, known rule kinds, per-kind required fields, positive windows
    with fast < slow, known metric names (KNOWN_METRICS, unless
    ``custom_metric: true``), known capture actions, non-negative for_s.
    """
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["alerts config must be a mapping, got %s"
                % type(doc).__name__]
    block = doc.get("alerts", doc)
    if not isinstance(block, dict):
        return ["alerts: block must be a mapping"]
    rules = block.get("rules", [])
    if not isinstance(rules, list):
        return ["alerts.rules must be a list"]
    seen_names = set()
    for i, rule in enumerate(rules):
        if not isinstance(rule, dict):
            errors.append("rule #%d: must be a mapping" % i)
            continue
        name = str(rule.get("name", "#%d" % i))
        if not rule.get("name"):
            errors.append("rule #%d: missing required field 'name'" % i)
        elif name in seen_names:
            errors.append("rule %s: duplicate name" % name)
        seen_names.add(name)
        kind = rule.get("kind")
        if kind not in RULE_KINDS:
            errors.append("rule %s: unknown kind %r (one of %s)"
                          % (name, kind, ", ".join(RULE_KINDS)))
            continue
        # Metric names.
        metrics = []
        if kind == "ratio_threshold":
            for f in ("numerator", "denominator"):
                if _require(rule, f, (str,), errors, name):
                    metrics.append(rule[f])
        else:
            if _require(rule, "metric", (str,), errors, name):
                metrics.append(rule["metric"])
        if not rule.get("custom_metric"):
            for m in metrics:
                if m not in KNOWN_METRICS:
                    errors.append("rule %s: unknown metric %r (not exported "
                                  "by this tree; set custom_metric: true to "
                                  "override)" % (name, m))
        # Windows.
        for f in ("window_s", "fast_window_s", "slow_window_s", "for_s"):
            if f == "for_s":
                v = rule.get(f)
                if v is not None and (not isinstance(v, (int, float))
                                      or isinstance(v, bool) or v < 0):
                    errors.append("rule %s: for_s must be >= 0, got %r"
                                  % (name, v))
            else:
                _check_window(rule, f, errors, name)
        if kind in ("error_burn_rate", "latency_burn_rate"):
            fast = rule.get("fast_window_s", FAST_WINDOW_S)
            slow = rule.get("slow_window_s", SLOW_WINDOW_S)
            if (isinstance(fast, (int, float)) and isinstance(slow, (int, float))
                    and not isinstance(fast, bool) and not isinstance(slow, bool)
                    and fast >= slow):
                errors.append("rule %s: fast_window_s (%s) must be < "
                              "slow_window_s (%s)" % (name, fast, slow))
            obj = rule.get("objective")
            if obj is None or not isinstance(obj, (int, float)) \
                    or isinstance(obj, bool) or not 0.0 < obj < 1.0:
                errors.append("rule %s: objective must be in (0, 1), got %r"
                              % (name, obj))
        if kind == "error_burn_rate":
            _require(rule, "bad_label", (str,), errors, name)
            if _require(rule, "bad_values", (list,), errors, name):
                if not rule["bad_values"]:
                    errors.append("rule %s: bad_values must be non-empty"
                                  % name)
        if kind == "latency_burn_rate":
            _require(rule, "threshold_ms", (int, float), errors, name)
        if kind in ("threshold", "ratio_threshold"):
            _require(rule, "value", (int, float), errors, name)
            op = rule.get("op", "gt")
            if op not in _OPS:
                errors.append("rule %s: op must be one of %s, got %r"
                              % (name, "/".join(_OPS), op))
            agg = rule.get("agg", "latest")
            if agg not in ("latest", "avg", "min", "max"):
                errors.append("rule %s: agg must be latest/avg/min/max, "
                              "got %r" % (name, agg))
        if kind == "goodput_floor":
            _require(rule, "floor", (int, float), errors, name)
            if _require(rule, "good_components", (list,), errors, name):
                if not rule["good_components"]:
                    errors.append("rule %s: good_components must be "
                                  "non-empty" % name)
        if kind == "zscore":
            z = rule.get("z", 4.0)
            if not isinstance(z, (int, float)) or isinstance(z, bool) \
                    or z <= 0:
                errors.append("rule %s: z must be > 0, got %r" % (name, z))
        if kind == "baseline_drop":
            _require(rule, "baseline_file", (str,), errors, name)
            _require(rule, "case", (str,), errors, name)
            _require(rule, "baseline_key", (str,), errors, name)
            frac = rule.get("max_drop_frac")
            if frac is None or not isinstance(frac, (int, float)) \
                    or isinstance(frac, bool) or not 0.0 < frac < 1.0:
                errors.append("rule %s: max_drop_frac must be in (0, 1), "
                              "got %r" % (name, frac))
        if kind == "flap":
            thr = rule.get("threshold", 3)
            if not isinstance(thr, int) or isinstance(thr, bool) or thr < 1:
                errors.append("rule %s: threshold must be an int >= 1, "
                              "got %r" % (name, thr))
        # Actions.
        actions = rule.get("actions", [])
        if not isinstance(actions, list):
            errors.append("rule %s: actions must be a list" % name)
        else:
            for a in actions:
                if a not in ACTIONS:
                    errors.append("rule %s: unknown action %r (one of %s)"
                                  % (name, a, ", ".join(ACTIONS)))
    return errors


def load_rules(path: str) -> List[Dict[str, Any]]:
    """Load + validate rules from an alerts.yaml; raises RuleError."""
    from ..config import read_config_dict

    doc = read_config_dict(path) or {}
    errors = validate_rules(doc)
    if errors:
        raise RuleError("invalid alerts config %s:\n  %s"
                        % (path, "\n  ".join(errors)))
    block = doc.get("alerts", doc)
    return list(block.get("rules", []))


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------


def _breach(op: str, value: float, bound: float) -> bool:
    if op == "gt":
        return value > bound
    if op == "lt":
        return value < bound
    if op == "ge":
        return value >= bound
    return value <= bound


def _agg_series(db: TSDB, name: str, labels: Dict[str, str], agg: str,
                t0: float, t1: float) -> List[float]:
    """Per-series time aggregation; returns one value per matching series.

    Callers reduce across series themselves (worst-wins: max for upper
    bounds, min for lower bounds) so a breach on any one instance alerts.
    """
    vals: List[float] = []
    for key in db.select(name, labels):
        _, ls = parse_series_key(key)
        pts = (db.query(name, ls) if agg == "latest"
               else db.query(name, ls, t0, t1))
        series_vals = [v for _, v in pts if math.isfinite(v)]
        if not series_vals:
            continue
        if agg == "latest":
            vals.append(series_vals[-1])
        elif agg == "avg":
            vals.append(sum(series_vals) / len(series_vals))
        elif agg == "min":
            vals.append(min(series_vals))
        else:
            vals.append(max(series_vals))
    return vals


def _eval_threshold(rule: Dict[str, Any], db: TSDB,
                    now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 60.0))
    agg = rule.get("agg", "latest")
    op = rule.get("op", "gt")
    vals = _agg_series(db, rule["metric"], rule.get("labels") or {}, agg,
                       now - window, now)
    if not vals:
        return False, None
    # Worst-series-wins: for an upper bound the max is the worst, for a
    # lower bound the min is.
    value = max(vals) if op in ("gt", "ge") else min(vals)
    return _breach(op, value, float(rule["value"])), value


def _eval_ratio(rule: Dict[str, Any], db: TSDB,
                now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 60.0))
    agg = rule.get("agg", "latest")
    op = rule.get("op", "lt")
    nums = _agg_series(db, rule["numerator"], rule.get("labels") or {},
                       agg, now - window, now)
    dens = _agg_series(db, rule["denominator"], rule.get("labels") or {},
                       agg, now - window, now)
    if not nums or not dens:
        return False, None
    num = max(nums) if op in ("gt", "ge") else min(nums)
    den = max(dens)
    if den == 0:
        return False, None
    value = num / den
    return _breach(op, value, float(rule["value"])), value


def _burn_windows(rule: Dict[str, Any]) -> Tuple[float, float, float]:
    fast = float(rule.get("fast_window_s", FAST_WINDOW_S))
    slow = float(rule.get("slow_window_s", SLOW_WINDOW_S))
    thr = float(rule.get("burn_threshold", 1.0))
    return fast, slow, thr


def _eval_error_burn(rule: Dict[str, Any], db: TSDB,
                     now: float) -> Tuple[bool, Optional[float]]:
    fast, slow, thr = _burn_windows(rule)
    budget = 1.0 - float(rule["objective"])
    metric = rule["metric"]
    label = rule["bad_label"]
    burns = []
    for window in (fast, slow):
        t0 = now - window
        total = db.sum_increase(metric, rule.get("labels") or {}, t0, now)
        if total <= 0:
            return False, None
        bad = 0.0
        for v in rule["bad_values"]:
            sel = dict(rule.get("labels") or {})
            sel[label] = str(v)
            bad += db.sum_increase(metric, sel, t0, now)
        burns.append((bad / total) / budget)
    return min(burns) >= thr, burns[0]


def _eval_latency_burn(rule: Dict[str, Any], db: TSDB,
                       now: float) -> Tuple[bool, Optional[float]]:
    fast, slow, thr = _burn_windows(rule)
    budget = 1.0 - float(rule["objective"])
    metric = rule["metric"]
    threshold_ms = float(rule["threshold_ms"])
    base_labels = rule.get("labels") or {}
    burns = []
    for window in (fast, slow):
        t0 = now - window
        total = db.sum_increase(metric + "_count", base_labels, t0, now)
        if total <= 0:
            return False, None
        # Buckets are cumulative in le: the increase of the smallest
        # bucket bounding the threshold counts the *good* (fast-enough)
        # requests; summed per instance because each stores its own le
        # label formatting.
        good = 0.0
        by_le: Dict[float, float] = {}
        for key in db.select(metric + "_bucket", base_labels):
            _, ls = parse_series_key(key)
            le = ls.get("le")
            if le in (None, "+Inf"):
                continue
            try:
                le_f = float(le)
            except ValueError:
                continue
            if le_f >= threshold_ms:
                by_le.setdefault(le_f, 0.0)
                by_le[le_f] += db.increase(metric + "_bucket", ls, t0, now)
        if by_le:
            good = by_le[min(by_le)]
        bad_frac = max(0.0, 1.0 - good / total)
        burns.append(bad_frac / budget)
    return min(burns) >= thr, burns[0]


def _eval_goodput_floor(rule: Dict[str, Any], db: TSDB,
                        now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 300.0))
    t0 = now - window
    metric = rule["metric"]
    total = db.sum_increase(metric, {}, t0, now)
    if total <= 0:
        return False, None
    good = 0.0
    for comp in rule["good_components"]:
        good += db.sum_increase(metric, {"component": str(comp)}, t0, now)
    frac = good / total
    return frac < float(rule["floor"]), frac


def _eval_zscore(rule: Dict[str, Any], db: TSDB,
                 now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 600.0))
    z_bound = float(rule.get("z", 4.0))
    min_points = int(rule.get("min_points", 8))
    direction = rule.get("direction", "above")
    worst: Optional[float] = None
    for key in db.select(rule["metric"], rule.get("labels") or {}):
        _, ls = parse_series_key(key)
        pts = [v for _, v in db.query(rule["metric"], ls, now - window, now)
               if math.isfinite(v)]
        if len(pts) < min_points + 1:
            continue
        trail, newest = pts[:-1], pts[-1]
        mean = sum(trail) / len(trail)
        std = statistics.pstdev(trail)
        if std <= 1e-12:
            continue
        z = (newest - mean) / std
        if direction == "above":
            score = z
        elif direction == "below":
            score = -z
        else:
            score = abs(z)
        if worst is None or score > worst:
            worst = score
    if worst is None:
        return False, None
    return worst >= z_bound, worst


def _eval_nonfinite(rule: Dict[str, Any], db: TSDB,
                    now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 120.0))
    metric = rule["metric"]
    if metric.endswith("_total"):
        inc = db.sum_increase(metric, rule.get("labels") or {},
                              now - window, now)
        return inc > 0, inc
    for key in db.select(metric, rule.get("labels") or {}):
        _, ls = parse_series_key(key)
        for _, v in db.query(metric, ls, now - window, now):
            if not math.isfinite(v):
                return True, v
    return False, 0.0


def _eval_baseline_drop(rule: Dict[str, Any], db: TSDB, now: float,
                        baseline_cache: Dict[str, Any]) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 300.0))
    min_points = int(rule.get("min_points", 3))
    path = rule["baseline_file"]
    if path not in baseline_cache:
        try:
            with open(path) as fh:
                baseline_cache[path] = json.load(fh)
        except (OSError, ValueError):
            baseline_cache[path] = None
    doc = baseline_cache[path]
    if not doc:
        return False, None
    backend = rule.get("backend", "cpu")
    case = (doc.get("backends", {}).get(backend, {})
            .get("cases", {}).get(rule["case"], {}))
    baseline = case.get(rule["baseline_key"])
    if not isinstance(baseline, (int, float)) or baseline <= 0:
        return False, None
    pts: List[float] = []
    for key in db.select(rule["metric"], rule.get("labels") or {}):
        _, ls = parse_series_key(key)
        pts.extend(v for _, v in db.query(rule["metric"], ls,
                                          now - window, now)
                   if math.isfinite(v) and v > 0)
    if len(pts) < min_points:
        return False, None
    avg = sum(pts) / len(pts)
    floor = baseline * (1.0 - float(rule["max_drop_frac"]))
    return avg < floor, avg


def _eval_flap(rule: Dict[str, Any], db: TSDB,
               now: float) -> Tuple[bool, Optional[float]]:
    window = float(rule.get("window_s", 300.0))
    threshold = int(rule.get("threshold", 3))
    worst = 0
    for key in db.select(rule["metric"], rule.get("labels") or {}):
        _, ls = parse_series_key(key)
        pts = [v for _, v in db.query(rule["metric"], ls, now - window, now)]
        flips = sum(1 for a, b in zip(pts, pts[1:]) if a != b)
        worst = max(worst, flips)
    if worst == 0:
        return False, None
    return worst >= threshold, float(worst)


_EVALUATORS = {
    "threshold": _eval_threshold,
    "ratio_threshold": _eval_ratio,
    "error_burn_rate": _eval_error_burn,
    "latency_burn_rate": _eval_latency_burn,
    "goodput_floor": _eval_goodput_floor,
    "zscore": _eval_zscore,
    "nonfinite": _eval_nonfinite,
    "flap": _eval_flap,
}


class AlertState:
    """One rule's pending→firing→resolved state machine."""

    __slots__ = ("rule", "state", "pending_since", "fired_at", "last_value",
                 "fire_count")

    def __init__(self, rule: Dict[str, Any]) -> None:
        self.rule = rule
        self.state = "inactive"
        self.pending_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.last_value: Optional[float] = None
        self.fire_count = 0

    def step(self, breached: bool, value: Optional[float],
             now: float) -> List[Dict[str, Any]]:
        """Advance the machine one evaluation; returns emitted transitions."""
        self.last_value = value
        for_s = float(self.rule.get("for_s", 0.0))
        out: List[Dict[str, Any]] = []

        def emit(frm: str, to: str) -> None:
            out.append({"t": now, "rule": self.rule["name"], "from": frm,
                        "to": to,
                        "value": (round(value, 6)
                                  if isinstance(value, (int, float))
                                  and math.isfinite(value) else value)})

        if breached:
            if self.state == "inactive":
                self.pending_since = now
                if for_s <= 0:
                    self.state = "firing"
                    self.fired_at = now
                    self.fire_count += 1
                    emit("inactive", "firing")
                else:
                    self.state = "pending"
                    emit("inactive", "pending")
            elif self.state == "pending":
                if now - (self.pending_since or now) >= for_s:
                    self.state = "firing"
                    self.fired_at = now
                    self.fire_count += 1
                    emit("pending", "firing")
        else:
            if self.state == "pending":
                self.state = "inactive"
                self.pending_since = None
                emit("pending", "inactive")
            elif self.state == "firing":
                self.state = "inactive"
                self.pending_since = None
                emit("firing", "resolved")
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {
            "rule": self.rule["name"],
            "kind": self.rule["kind"],
            "state": self.state,
            "value": self.last_value,
            "pending_since": self.pending_since,
            "fired_at": self.fired_at,
            "fire_count": self.fire_count,
            "actions": list(self.rule.get("actions", [])),
        }


class RuleEngine:
    """Evaluates every rule against the TSDB and tracks alert state.

    Single-threaded by design: only the collector thread calls
    :meth:`evaluate`; readers (GET /alerts) consume immutable snapshots
    handed over by the collector under its own lock.
    """

    def __init__(self, rules: List[Dict[str, Any]], db: TSDB) -> None:
        errors = validate_rules({"alerts": {"rules": rules}})
        if errors:
            raise RuleError("invalid rules:\n  " + "\n  ".join(errors))
        self.db = db
        self.states = [AlertState(r) for r in rules]
        self._baseline_cache: Dict[str, Any] = {}

    def evaluate(self, now: float) -> List[Dict[str, Any]]:
        """One evaluation round; returns all transitions (may be empty)."""
        transitions: List[Dict[str, Any]] = []
        for st in self.states:
            kind = st.rule["kind"]
            try:
                if kind == "baseline_drop":
                    breached, value = _eval_baseline_drop(
                        st.rule, self.db, now, self._baseline_cache)
                else:
                    breached, value = _EVALUATORS[kind](st.rule, self.db, now)
            except Exception:
                # A rule evaluation bug must never take down the
                # collector; treat as no-data.
                breached, value = False, None
            transitions.extend(st.step(breached, value, now))
        return transitions

    def firing(self) -> List[str]:
        return [st.rule["name"] for st in self.states
                if st.state == "firing"]

    def snapshot(self) -> Dict[str, Any]:
        return {"alerts": [st.snapshot() for st in self.states]}


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m ...obs.alerts --validate configs/alerts.yaml``."""
    import argparse

    p = argparse.ArgumentParser(
        description="Validate an alerts config")
    p.add_argument("--validate", metavar="PATH", required=True,
                   help="alerts.yaml to check")
    args = p.parse_args(argv)
    from ..config import read_config_dict

    try:
        doc = read_config_dict(args.validate) or {}
    except OSError as e:
        print("alerts: cannot read %s: %s" % (args.validate, e))
        return 1
    except Exception as e:  # noqa: BLE001 - PyYAML's or yaml_lite's error
        print("alerts: %s is not valid YAML: %s" % (args.validate, e))
        return 1
    errors = validate_rules(doc)
    if errors:
        for err in errors:
            print("alerts: %s" % err)
        print("alerts: %d error(s) in %s" % (len(errors), args.validate))
        return 1
    block = doc.get("alerts", doc)
    n = len(block.get("rules", []))
    print("alerts: %s OK (%d rule(s))" % (args.validate, n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
