"""The torch port's outbound-call policy (``serve/policy.py``) against the
JAX package's, on the CPU.

The same inputs go through both modules: deadlines parsed from the same
headers and clamped at the same remaining budget, the jittered backoff for
the same keys, the retry budget and the circuit breaker driven by one
scripted clock, and ``CallPolicy.call`` against one stub HTTP server with
the same fault armed in each package's ``serve/faults.py``. Each result,
and each published gauge, must be equal.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from mlx_cuda_distributed_pretraining_tpu.obs.metrics import MetricsRegistry as JRegistry
from mlx_cuda_distributed_pretraining_tpu.serve import faults as jfaults
from mlx_cuda_distributed_pretraining_tpu.serve import policy as jpol
from mlx_cuda_distributed_pretraining_tpu_torch.obs.metrics import MetricsRegistry
from mlx_cuda_distributed_pretraining_tpu_torch.serve import faults as tfaults
from mlx_cuda_distributed_pretraining_tpu_torch.serve import policy as tpol
from mlx_cuda_distributed_pretraining_tpu_torch.serve import scheduler as tsched

PACKAGES = {"jax": (jpol, jfaults, JRegistry), "torch": (tpol, tfaults, MetricsRegistry)}


@pytest.fixture(autouse=True)
def _disarm():
    for f in (jfaults, tfaults):
        f.reset()
    yield
    for f in (jfaults, tfaults):
        f.reset()


class _Clock:
    """A scripted ``time.monotonic`` shared by both packages' policy code."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "monotonic", c)
    return c


@pytest.mark.parametrize("header", [None, "", "abc", "0", "1", "250", "60000", "-5",
                                    "12.5"])
def test_deadline_parses_clamps_and_forwards_as_jax(clock, header):
    out = {}
    for name, (pol, _, _) in PACKAGES.items():
        d = pol.Deadline.from_header({} if header is None else
                                     {pol.DEADLINE_HEADER: header})
        row = {"none": d is None}
        if d is not None:
            row["remaining_ms"] = d.remaining_ms()
            row["header"] = d.header_value()
            row["expired"] = d.expired()
            try:
                row["clamp"] = d.clamp(30.0)
            except pol.DeadlineExceeded as e:
                row["clamp"] = ("raised", isinstance(e, TimeoutError), str(e))
            clock.t += 0.1
            row["later_header"] = d.header_value()
            clock.t -= 0.1
        out[name] = row
    assert out["torch"] == out["jax"]
    assert tpol.DEADLINE_HEADER == "X-Deadline-Ms"


@pytest.mark.parametrize("base,cap", [(0.05, 2.0), (0.1, 0.5), (1.0, 60.0)])
def test_jittered_backoff_sequence_equals_jax(base, cap):
    keys = ["", "trace-0", "ab" * 16, "http://127.0.0.1:8451"]
    for key in keys:
        seq_t = [tpol.backoff_s(a, base=base, cap=cap, key=key) for a in range(12)]
        seq_j = [jpol.backoff_s(a, base=base, cap=cap, key=key) for a in range(12)]
        assert seq_t == seq_j
        assert all(0.0 < x <= cap for x in seq_t[1:])
    cfg = dict(base_backoff_s=base, max_backoff_s=cap)
    tp, jp = tpol.CallPolicy(tpol.PolicyConfig(**cfg)), jpol.CallPolicy(jpol.PolicyConfig(**cfg))
    assert [tp.backoff(a, key="k") for a in range(8)] == [jp.backoff(a, key="k")
                                                          for a in range(8)]


def test_retry_budget_spends_and_refills_as_jax(clock):
    script = [("take", 0.0)] * 10 + [("tick", 0.5), ("take", 0.0), ("tick", 3.0),
                                     ("take", 0.0), ("take", 0.0), ("tick", 100.0),
                                     ("tokens", 0.0)]
    out = {}
    for name, (pol, _, _) in PACKAGES.items():
        clock.t = 1000.0
        b = pol.TokenBucket(capacity=4.0, refill_per_s=2.0)
        rows = []
        for op, dt in script:
            if op == "tick":
                clock.t += dt
            elif op == "take":
                rows.append((b.try_take(1.0), round(b.tokens(), 9)))
            else:
                rows.append(round(b.tokens(), 9))
        out[name] = rows
    assert out["torch"] == out["jax"]


def test_circuit_breaker_transitions_as_jax(clock):
    # five failures open it; allow() refuses until breaker_open_s; one
    # half-open probe; its failure re-opens, a later probe's success closes
    script = (["fail"] * 5 + ["allow", "allow", ("tick", 1.0), "allow",
                              ("tick", 1.5), "allow", "allow", "fail", "allow",
                              ("tick", 2.5), "allow", "ok", "allow", "fail", "allow"])
    out = {}
    for name, (pol, _, _) in PACKAGES.items():
        clock.t = 1000.0
        br = pol.CircuitBreaker(threshold=5, open_for_s=2.0)
        rows = []
        for op in script:
            if isinstance(op, tuple):
                clock.t += op[1]
            elif op == "allow":
                rows.append(("allow", br.allow(), br.state, br.state_code()))
            else:
                br.record(op == "ok")
                rows.append((op, br.state, br.state_code()))
        out[name] = rows
    assert out["torch"] == out["jax"]
    assert ("allow", False, "open", 1) in out["torch"]
    assert any(r[2] == "half_open" for r in out["torch"] if r[0] == "allow")


class _Stub:
    """One HTTP server that answers ``/ok`` and 500s on ``/err``."""

    def __init__(self):
        seen = self.seen = []

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                n = int(self.headers.get("Content-Length", "0") or 0)
                body = self.rfile.read(n) if n else b""
                seen.append((self.path, self.headers.get("X-Deadline-Ms"), body))
                code = 500 if self.path.startswith("/err") else 200
                data = json.dumps({"path": self.path}).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _answer

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _drive_policy(pol, faults, registry_cls, url):
    """A fixed sequence of calls under one armed fault rule; every outcome,
    then the gauges of the bound registry."""
    reg = registry_cls()
    p = pol.CallPolicy(pol.PolicyConfig(max_attempts=3, base_backoff_s=0.001,
                                        max_backoff_s=0.002, breaker_threshold=3,
                                        breaker_open_s=30.0, retry_budget=2.0,
                                        retry_refill_per_s=0.0), registry=reg)
    faults.inject("http.connect_refused", every=2, match="/flaky")
    rows = []
    calls = [(path, 3) for path in ("/ok", "/flaky/a", "/flaky/b", "/err", "/flaky/c",
                                    "/flaky/d", "/flaky/e", "/ok")]
    # then a dead destination: three refusals open its breaker, the fourth
    # call is refused locally
    calls += [(f"/dead/{i}", 1) for i in range(4)]
    for path, attempts in calls:
        if path == "/dead/0":
            faults.inject("http.connect_refused", every=1, match="/dead")
        try:
            body = p.call(url + path, timeout=5.0, method="GET", max_attempts=attempts,
                          deadline=pol.Deadline.after(30.0), backoff_key=path)
            rows.append(("ok", json.loads(body)["path"]))
        except Exception as e:  # noqa: BLE001 - the outcome is the result
            rows.append((type(e).__name__,))
        rows.append((p.breaker_state(url), round(p.tokens(url), 6)))
    p.publish()
    snap = reg.snapshot()
    gauges = {name: [(s["labels"], s["value"]) for s in snap[name]["series"]]
              for name in ("serve_breaker_state", "serve_retry_budget_tokens",
                           "serve_faults_injected_total")}
    return rows, gauges, faults.counts()


def test_call_policy_under_injected_refusals_equals_jax(clock):
    clock.t = 5000.0
    stub = _Stub()
    try:
        t = _drive_policy(tpol, tfaults, MetricsRegistry, stub.url)
        stub.seen.clear()
        j = _drive_policy(jpol, jfaults, JRegistry, stub.url)
    finally:
        stub.close()
    # the retry-budget gauge rounds the bucket read at publish time
    assert t[0] == j[0]
    assert t[1] == j[1] and t[2] == j[2]
    assert ("HTTPError",) in t[0] and ("URLError",) in t[0]
    assert t[0][-2:] == [("BreakerOpenError",), ("open", 0.0)]


def test_call_stamps_the_remaining_deadline_as_jax():
    stub = _Stub()
    try:
        for pol in (tpol, jpol):
            p = pol.CallPolicy()
            p.call(stub.url + "/ok", data=b"{}", method="POST",
                   deadline=pol.Deadline.after(5.0))
            with pytest.raises(pol.DeadlineExceeded):
                p.call(stub.url + "/ok", deadline=pol.Deadline.after(0.0))
    finally:
        stub.close()
    stamped = [int(h) for _, h, _ in stub.seen]
    assert len(stamped) == 2 and all(4000 < ms <= 5000 for ms in stamped)


def test_policy_config_and_admission_error_are_jaxs():
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "serve-sample.yaml")
    assert vars(tpol.PolicyConfig.from_yaml(path)) == vars(jpol.PolicyConfig.from_yaml(path))
    # the scheduler refuses an unmeetable deadline with the policy's error,
    # a DeadlineExceeded and so a TimeoutError (-> 504), as in JAX
    assert tsched.AdmissionRefusedError is tpol.AdmissionRefusedError
    assert issubclass(tpol.AdmissionRefusedError, tpol.DeadlineExceeded)
    assert issubclass(tpol.BreakerOpenError, ConnectionError)
    assert [c.__name__ for c in tpol.AdmissionRefusedError.__mro__] == \
        [c.__name__ for c in jpol.AdmissionRefusedError.__mro__]
