"""HTTP inference server over a trained run (or seeded random weights).

    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.server \\
        --run myrun --runs-root runs --port 8400
    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.server \\
        --config configs/model-config-moe-8x40m.yaml --seed 0 --engine batch

    POST /generate {"prompt": "...", "max_tokens": 64, "temperature": 0.8}
      -> {"text": ..., "tokens": N, "generation_tps": ..., ...}
    POST /v1/completions   the OpenAI completions shape of the same
    GET /healthz           {"status": "ok", "params_m": ..., ...}
    GET /v1/models
    GET /metrics           the batch engine's metrics as JSON
    GET /trace             the engine's span ring as a Chrome trace (?clear=1
                           drains it)
    POST /prefill          fleet handoff: prefill only, then push the KV
                           chain to the decode replica ``transfer_to`` names
    POST /adopt_kv         install a pushed GKV1 payload (binary body); an
                           ``X-Params-Version`` other than this engine's
                           adopts nothing
    POST /admin/drain, /admin/undrain   503 to new work while draining
    POST /admin/swap_weights {"model_path": ...} or {"run_dir": ...}

The weights live on ``--device`` (default ``cuda``). Two engines
(``--engine``):

- ``locked`` (default): one request at a time behind a lock, through
  ``infer/generate.py``'s ``generate_text`` (samplers, repetition penalty,
  ``--kv-quant``, ``--spec``);
- ``batch``: the continuous-batching engine (``serve/engine.py``) over a
  paged (``--kv-backend paged``, default) or slotted KV pool, fp32 or int8
  (``--kv-quant``), with in-batch speculation (``--spec-draft-len``,
  ``--spec-max-ngram``) and weight-only int8/int4 (``--weight-dtype``,
  quantized as the checkpoint loads). A full admission queue returns 429,
  a missed deadline 504. Requests whose effective knobs reshape the logits
  (top_p, min_p, repetition_penalty) fall back to the locked path: the
  batched step samples by temperature only.

Streaming: a ``"stream": true`` body answers with SSE (text/event-stream):
one ``data: {"token": id, "text": delta}`` event per token, then ``data:
{"done": true, ...result}``. Batch-engine requests stream token by token;
locked and fallback requests send the final event only.

Tracing: an ``X-Trace-Id`` header (``obs.trace.TRACE_HEADER``) keys the
request's spans in the batch engine (``--trace``); without one the engine
mints an id, and the result carries it. ``--metrics-port`` serves the
engine's registry as Prometheus text; ``--stats-url`` publishes to a stats
hub.

The fleet (``serve/fleet.py``): an ``X-Deadline-Ms`` header (the router's
remaining budget) tightens the body's ``deadline_s`` and answers 504
before any engine work once it is spent; ``--role`` names the replica's
pool, and ``--fleet-dir`` / ``--fleet-index`` register it in the fleet's
membership directory and keep its heartbeat. A serving mesh of more than
one device (``--mesh``) is not ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue as queue_mod
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..models import llama
from ..obs.trace import TRACE_HEADER
from ..serve import BatchEngine, EngineConfig, QueueFullError
from ..serve.kv_transfer import PARAMS_VERSION_HEADER
from ..serve.policy import Deadline
from .generate import generate_text


class InferenceService:
    """Owns the model, serializes locked generation, and routes requests to
    the batch engine when one is attached."""

    def __init__(self, params, args, tokenizer, kv_quant: bool = False,
                 run_name: str = "?", max_tokens_limit: int = 4096,
                 speculative: bool = False, draft_len: int = 8):
        self.params = params
        self.args = args
        self.tokenizer = tokenizer
        self.kv_quant = kv_quant
        self.run_name = run_name
        self.max_tokens_limit = max_tokens_limit
        self.speculative = speculative
        self.draft_len = draft_len
        self.lock = threading.Lock()
        self.n_params = llama.num_params(params)
        self.started_at = int(time.time())
        self.engine: Optional[BatchEngine] = None
        # A draining replica refuses new generation work (503: the router
        # takes it off the ring) while in-flight requests run to the end:
        # the graceful half of a scale-down or a weight swap.
        self.draining = False

    def attach_engine(self, cfg: Optional[EngineConfig] = None) -> BatchEngine:
        """Start the batch engine and route compatible requests through it;
        the locked path stays for the logit-reshaping knobs. ``max_len`` is
        clamped to the model's ``max_position_embeddings``."""
        cfg = cfg or EngineConfig(kv_quant=self.kv_quant)
        if cfg.max_len > self.args.max_position_embeddings:
            cfg = dataclasses.replace(
                cfg, max_len=self.args.max_position_embeddings)
        self.engine = BatchEngine(self.params, self.args, self.tokenizer,
                                  cfg).start()
        return self.engine

    def close(self) -> None:
        if self.engine is not None:
            self.engine.stop()
            self.engine = None

    @classmethod
    def from_run(cls, run: str, runs_root: str = "runs", device="cuda",
                 weight_dtype: str = "fp", **kw) -> "InferenceService":
        """A trained run's newest verified checkpoint; ``weight_dtype``
        "int8"/"int4" quantizes its linear weights as they load."""
        from ..train.trainer import load_trained

        params, args, tok, _cfg = load_trained(run, runs_root=runs_root,
                                               device=device,
                                               weight_dtype=weight_dtype)
        return cls(params, args, tok, run_name=run, **kw)

    @classmethod
    def from_config(cls, path: str, seed: int = 0, device="cuda",
                    **kw) -> "InferenceService":
        """Random weights at a model config's shapes, drawn from ``seed``."""
        import torch

        from ..config import Config
        from ..tokenizer import TokenizerManager

        cfg = Config.from_yaml(path)
        tok = TokenizerManager(cfg.data)
        args = llama.LlamaArgs.from_config(cfg.model, tok.vocab_size)
        params = llama.init_params(args, torch.Generator().manual_seed(seed),
                                   device=device)
        return cls(params, args, tok, run_name=cfg.name, **kw)

    @staticmethod
    def _quantize(x: float, step: float = 0.05) -> float:
        """Client floats snapped to a 0.05 grid, as the JAX server does to
        bound its compiled decode variants; kept so both servers run a
        request with the same knobs."""
        return round(round(x / step) * step, 2)

    def _knobs(self, temperature, top_p, min_p, repetition_penalty):
        """The effective knobs, and whether they reshape the logits (which
        turns off speculation and the batch engine)."""
        q_rep = (self._quantize(repetition_penalty)
                 if repetition_penalty else None)
        knobs = {"temperature": self._quantize(temperature),
                 "top_p": self._quantize(top_p), "min_p": self._quantize(min_p),
                 "repetition_penalty": q_rep}
        reshapes = bool(knobs["top_p"] or knobs["min_p"] or (q_rep or 1.0) != 1.0)
        return knobs, reshapes

    def _clamp(self, max_tokens: int) -> int:
        # an unbounded client value would allocate a huge cache under the lock
        return max(1, min(int(max_tokens), self.max_tokens_limit))

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, top_p: float = 0.0,
                 min_p: float = 0.0,
                 repetition_penalty: Optional[float] = None,
                 seed: int = 0,
                 deadline_s: Optional[float] = None,
                 trace_id: Optional[str] = None) -> dict:
        max_tokens = self._clamp(max_tokens)
        knobs, reshapes = self._knobs(temperature, top_p, min_p, repetition_penalty)
        effective = {**knobs, "max_tokens": max_tokens}
        if self.engine is not None and not reshapes:
            out = self.engine.generate(prompt, max_tokens=max_tokens,
                                       temperature=knobs["temperature"], seed=seed,
                                       deadline_s=deadline_s, trace_id=trace_id)
            out["effective_params"] = effective
            return out
        spec = self.speculative and not reshapes
        with self.lock:
            text, stats = generate_text(
                self.params, self.args, self.tokenizer, prompt,
                max_new_tokens=max_tokens, temperature=knobs["temperature"],
                top_p=knobs["top_p"], min_p=knobs["min_p"],
                repetition_penalty=knobs["repetition_penalty"],
                seed=seed, kv_quant=self.kv_quant, return_stats=True,
                speculative=spec, draft_len=self.draft_len)
        return {
            "text": text,
            "tokens": int(stats["generation_tokens"]),
            "speculative": spec,
            # the knobs the decode ran with: snapped to the grid, clamped
            "effective_params": effective,
            **{k: round(float(v), 4) for k, v in stats.items()},
        }

    def submit_stream(self, prompt: str, max_tokens: int = 64,
                      temperature: float = 0.0, top_p: float = 0.0,
                      min_p: float = 0.0,
                      repetition_penalty: Optional[float] = None,
                      seed: int = 0,
                      deadline_s: Optional[float] = None,
                      trace_id: Optional[str] = None):
        """Submit through the batch engine for token-by-token streaming;
        None when the request takes the locked path instead (no engine, or
        logit-reshaping knobs)."""
        if self.engine is None:
            return None
        knobs, reshapes = self._knobs(temperature, top_p, min_p, repetition_penalty)
        if reshapes:
            return None
        return self.engine.submit(prompt, max_tokens=self._clamp(max_tokens),
                                  temperature=knobs["temperature"], seed=seed,
                                  deadline_s=deadline_s, stream=True,
                                  trace_id=trace_id)

    def health(self) -> dict:
        d = {
            "status": "draining" if self.draining else "ok",
            "run": self.run_name,
            "architecture": "llama",
            "params_m": round(self.n_params / 1e6, 2),
            "vocab_size": self.args.vocab_size,
            "kv_quant": self.kv_quant,
            "max_tokens_limit": self.max_tokens_limit,
            "speculative": self.speculative,
            "draft_len": self.draft_len,
        }
        if self.engine is not None:
            d["engine"] = "batch"
            d["serve"] = self.engine.metrics()
        return d

    def metrics(self) -> dict:
        """GET /metrics: the batch engine's metrics (the JAX server's keys)."""
        base = (self.engine.metrics() if self.engine is not None
                else {"engine": "locked", "role": "any"})
        base["draining"] = self.draining
        return base

    # -- the fleet -------------------------------------------------------------
    def prefill_handoff(self, body: dict,
                        trace_id: Optional[str] = None) -> dict:
        """POST /prefill: run a prefill-only request (the prompt's KV written
        and published, no token sampled), export its block chain and, when
        ``transfer_to`` names a decode replica, push it there inside a
        ``kv_transfer`` span. The router then sends the original request to
        that replica, whose admission adopts the chain."""
        if self.engine is None:
            raise ValueError("/prefill requires --engine batch")
        prompt = body["prompt"]
        if isinstance(prompt, list):
            prompt = prompt[0]
        if not isinstance(prompt, str):
            raise ValueError("'prompt' must be a string")
        dl = body.get("deadline_s")
        req = self.engine.submit(prompt, max_tokens=1, temperature=0.0,
                                 seed=int(body.get("seed", 0)),
                                 deadline_s=float(dl) if dl is not None else None,
                                 trace_id=trace_id, prefill_only=True)
        # without a pinned wait, follow the request's own budget: waiting
        # past the deadline the engine evicts at only holds a thread
        wait_s = body.get("timeout_s")
        if wait_s is None:
            wait_s = float(dl) + 5.0 if dl is not None else 300.0
        if not req.wait(timeout=float(wait_s)):
            raise TimeoutError("prefill did not complete in time")
        if req.error is not None:
            raise TimeoutError(req.error)
        payload = self.engine.export_kv(req.prompt_ids, trace_id=trace_id)
        out = {
            "prefill": True,
            "prompt_tokens": len(req.prompt_ids),
            "blocks": payload.num_blocks,
            "trace_id": req.trace_id,
            **{k: req.result[k] for k in ("queue_ms", "prefill_ms")
               if k in (req.result or {})},
        }
        target = body.get("transfer_to")
        if target and payload.num_blocks:
            from ..serve.kv_transfer import push_payload

            t0 = time.perf_counter()
            try:
                stats = push_payload(target, payload, trace_id=trace_id)
            except Exception as e:  # noqa: BLE001 - an optimization lost
                # A failed push is never the client's error: the decode
                # replica misses its cache and prefills locally.
                self.engine.note_kv_failure("push")
                out["transfer_error"] = f"{type(e).__name__}: {e}"
                return out
            dur = time.perf_counter() - t0
            if self.engine.tracer.enabled:
                # the span that joins the two replicas' trees
                self.engine.tracer.complete(
                    "kv_transfer", dur, trace_id=trace_id, target=target,
                    blocks=payload.num_blocks, bytes=payload.nbytes(), **stats)
            out.update({"transfer_ms": round(dur * 1e3, 2),
                        "transfer_bytes": payload.nbytes(), **stats})
        return out

    def adopt_kv(self, data: bytes, trace_id: Optional[str] = None,
                 params_version: Optional[int] = None) -> dict:
        """POST /adopt_kv: install a pushed KV payload into this replica's
        arena. A payload that fails the integrity gate is refused (400) and
        the chain keys it claimed are quarantined out of the prefix cache,
        so no later admission adopts blocks a corrupt sender vouched for.
        A sender's ``X-Params-Version`` other than this engine's adopts
        nothing (``BatchEngine.adopt_kv``)."""
        if self.engine is None:
            raise ValueError("/adopt_kv requires --engine batch")
        from ..serve.kv_transfer import KVTransferPayload

        try:
            payload = KVTransferPayload.from_bytes(data)
        except ValueError:
            self._quarantine_claimed_keys(data)
            raise
        return self.engine.adopt_kv(payload, trace_id=trace_id,
                                    params_version=params_version)

    def _quarantine_claimed_keys(self, data: bytes) -> None:
        """Drop the chain keys a refused payload claimed in its (perhaps
        damaged) header from the prefix cache; an unreadable header still
        counts the failure."""
        keys = []
        try:
            (hlen,) = struct.unpack_from("<I", data, 4)
            header = json.loads(data[8:8 + hlen].decode())
            keys = [bytes.fromhex(k) for k in header.get("keys", [])]
        except Exception:  # noqa: BLE001 - the header may be the damage
            pass
        if keys:
            self.engine.quarantine_kv(keys, reason="corrupt")
        else:
            self.engine.note_kv_failure("corrupt")

    def swap_weights(self, body: dict) -> dict:
        """POST /admin/swap_weights: load a checkpoint (``model_path``, or
        the newest verified step under ``run_dir``) shaped like the serving
        weights and cut over between engine iterations; in-flight requests
        finish on the new weights, nothing is evicted or failed."""
        from ..checkpoint.manager import CheckpointManager, latest_model_path

        model_path = body.get("model_path")
        if not model_path and body.get("run_dir"):
            model_path = latest_model_path(body["run_dir"])
            if model_path is None:
                raise ValueError(
                    f"no complete checkpoint under {body['run_dir']!r}")
        if not model_path:
            raise ValueError("need 'model_path' or 'run_dir'")
        like = self.engine.params if self.engine is not None else self.params
        new = CheckpointManager.load_params(model_path, like=like)
        version = 0
        if self.engine is not None:
            # the engine moves the tree to its device (and its weight dtype)
            version = self.engine.swap_params(new)
            new = self.engine.params
        else:
            from ..utils.tree import tree_map

            device = self.params["tok_embeddings"]["weight"].device
            new = tree_map(lambda t: t.to(device), new)
        with self.lock:  # the locked path reads self.params per request
            self.params = new
        return {"swapped": True, "model_path": model_path,
                "params_version": version}

    def trace(self, clear: bool = False) -> dict:
        """GET /trace: the Chrome trace of the engine's span ring."""
        if self.engine is not None:
            return self.engine.tracer.chrome_trace(clear=clear)
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "metadata": {"service": "locked"}}


def _to_openai_completion(out: dict, req: dict, run_name: str,
                          tokenizer=None, effective_max: int = 0) -> dict:
    """The native /generate result in the OpenAI completions shape. ``stop``
    strings truncate the text (generation stops on EOS only); usage counts
    the text returned."""
    import uuid

    text = out["text"]
    completion_tokens = out["tokens"]
    # "stop" when the decode met a stop token, "length" when it ran out
    # the server-clamped budget
    if out.get("stopped_on_token"):
        finish = "stop"
    else:
        finish = "length" if completion_tokens >= effective_max else "stop"
    stops = req.get("stop")
    if isinstance(stops, str):
        stops = [stops]
    for s in stops or []:
        idx = text.find(s)
        if idx >= 0:
            text = text[:idx]
            finish = "stop"
    if text != out["text"] and tokenizer is not None:
        completion_tokens = len(tokenizer.tokenize(text))
    prompt_tokens = int(out.get("prompt_tokens", 0))
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "model": str(req.get("model") or run_name),
        "choices": [{"text": text, "index": 0, "logprobs": None,
                     "finish_reason": finish}],
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens,
                  "total_tokens": prompt_tokens + completion_tokens},
    }


def _parse(body: dict):
    """``(prompt, knobs)`` of a /generate or /v1/completions body; a list
    prompt holds exactly one string (OpenAI allows str | [str])."""
    if not isinstance(body, dict) or "prompt" not in body:
        raise ValueError("body must be a JSON object with 'prompt'")
    prompt = body["prompt"]
    if isinstance(prompt, list):
        if len(prompt) != 1 or not isinstance(prompt[0], str):
            raise ValueError("list prompts must hold exactly one string "
                             "(batched completions are not supported)")
        prompt = prompt[0]
    elif not isinstance(prompt, str):
        raise ValueError("'prompt' must be a string")
    rp = body.get("repetition_penalty")
    dl = body.get("deadline_s")
    return prompt, dict(
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 0.0)),
        min_p=float(body.get("min_p", 0.0)),
        repetition_penalty=float(rp) if rp is not None else None,
        seed=int(body.get("seed", 0)),
        deadline_s=float(dl) if dl is not None else None)


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sse_begin(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

        def _sse(self, obj: dict):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(length)

        def _deadline_s(self, local: Optional[float]) -> Optional[float]:
            """The request's budget in seconds. An upstream
            ``X-Deadline-Ms`` (the router's remaining budget) is end to end:
            it replaces, or tightens, the body's ``deadline_s``. A spent
            budget raises (-> 504) before any engine work."""
            d = Deadline.from_header(self.headers)
            if d is None:
                return local
            rem = d.remaining_s()
            if rem <= 0.0:
                raise TimeoutError("deadline exhausted before admission")
            return min(local, rem) if local is not None else rem

        def _admin(self, path: str) -> None:
            if path in ("/admin/drain", "/admin/undrain"):
                # draining stops admission (503 below: the router takes
                # this replica off the ring); in-flight work runs on
                service.draining = path == "/admin/drain"
                m = service.metrics()
                self._reply(200, {
                    "draining": service.draining,
                    "inflight": int(m.get("batch_occupancy", 0)),
                    "queue_depth": int(m.get("queue_depth", 0))})
                return
            if path != "/admin/swap_weights":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                self._reply(200, service.swap_weights(
                    json.loads(self._body() or b"{}")))
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _adopt_kv(self) -> None:
            # a binary GKV1 body, allowed while draining: adoption only
            # warms the prefix cache and admits nothing
            try:
                version = self.headers.get(PARAMS_VERSION_HEADER)
                self._reply(200, service.adopt_kv(
                    self._body(), trace_id=self.headers.get(TRACE_HEADER),
                    params_version=int(version) if version is not None else None))
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _stream_generate(self, prompt: str, kw: dict) -> None:
            """SSE: token events as the engine emits them, then the result.
            Submission errors (429/400) raise before any header is sent."""
            sreq = service.submit_stream(prompt, **kw)
            if sreq is None:
                # locked path: compute fully (errors still map to a JSON
                # status), then send the final event
                out = service.generate(prompt=prompt, **kw)
                self._sse_begin()
                self._sse({"done": True, **out})
                return
            self._sse_begin()
            # the gap between tokens is bounded by the request's own budget
            dl = kw.get("deadline_s")
            gap_s = dl + 30.0 if dl is not None else 600.0
            toks: list = []
            prev = ""
            while True:
                try:
                    tok = sreq.stream_q.get(timeout=gap_s)
                except queue_mod.Empty:
                    self._sse({"done": True, "error": "stream timeout"})
                    return
                if tok is None:
                    break
                toks.append(int(tok))
                full = service.tokenizer.detokenize(toks)
                self._sse({"token": int(tok), "text": full[len(prev):]})
                prev = full
            sreq.wait(timeout=30.0)
            if sreq.error is not None:
                self._sse({"done": True, "error": sreq.error})
            else:
                self._sse({"done": True, **(sreq.result or {})})

        def do_GET(self):
            import urllib.parse

            parts = urllib.parse.urlsplit(self.path)
            path = parts.path.rstrip("/")
            if path in ("", "/healthz"):
                self._reply(200, service.health())
            elif path == "/metrics":
                self._reply(200, service.metrics())
            elif path == "/trace":
                # ?clear=1 drains the ring
                clear = "clear" in urllib.parse.parse_qs(parts.query)
                self._reply(200, service.trace(clear=clear))
            elif path == "/v1/models":
                self._reply(200, {
                    "object": "list",
                    "data": [{"id": service.run_name, "object": "model",
                              "created": service.started_at,
                              "owned_by": "local"}],
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            path = self.path.rstrip("/")
            if path.startswith("/admin/"):
                self._admin(path)
                return
            if path == "/adopt_kv":
                self._adopt_kv()
                return
            if path not in ("/generate", "/v1/completions", "/prefill"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            if service.draining:
                self._reply(503, {"error": "draining: not admitting new requests"})
                return
            try:
                req = json.loads(self._body() or b"{}")
                if path == "/prefill":
                    if not isinstance(req, dict) or "prompt" not in req:
                        raise ValueError("body must be a JSON object with 'prompt'")
                    dl = req.get("deadline_s")
                    eff = self._deadline_s(float(dl) if dl is not None else None)
                    if eff is not None:
                        req["deadline_s"] = eff
                    self._reply(200, service.prefill_handoff(
                        req, trace_id=self.headers.get(TRACE_HEADER)))
                    return
                prompt, kw = _parse(req)
                kw["deadline_s"] = self._deadline_s(kw["deadline_s"])
                effective_max = service._clamp(req.get("max_tokens", 64))
                kw["max_tokens"] = effective_max
                # a client's (or router's) trace id keys this request's spans
                kw["trace_id"] = self.headers.get(TRACE_HEADER)
                if req.get("stream"):
                    self._stream_generate(prompt, kw)
                    return
                out = service.generate(prompt=prompt, **kw)
                if path == "/v1/completions":
                    out = _to_openai_completion(
                        out, req, service.run_name,
                        tokenizer=service.tokenizer,
                        effective_max=effective_max)
                self._reply(200, out)
            except QueueFullError as e:
                self._reply(429, {"error": str(e)})
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - surface, don't kill the server
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: InferenceService, host: str = "127.0.0.1",
          port: int = 8400) -> ThreadingHTTPServer:
    """Start serving in a background thread; returns the server — stop with
    ``httpd.shutdown(); httpd.server_close()``. Port 0 picks a free port."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="infer-server")
    t.start()
    return httpd


def request_generate(url: str, prompt: str, timeout: float = 300.0,
                     **kwargs) -> dict:
    """Client helper: ``request_generate("http://h:8400", "hi")``."""
    import urllib.request

    body = json.dumps({"prompt": prompt, **kwargs}).encode()
    req = urllib.request.Request(
        url.rstrip("/") + "/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def request_stream(url: str, prompt: str, timeout: float = 300.0, **kwargs):
    """Streaming client: yields each SSE event of a ``"stream": true``
    /generate request (token events, then ``{"done": true, ...}``)."""
    import urllib.request

    body = json.dumps({"prompt": prompt, "stream": True, **kwargs}).encode()
    req = urllib.request.Request(
        url.rstrip("/") + "/generate", data=body,
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    try:
        buf = b""
        while True:
            chunk = resp.read1(8192)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                if raw.startswith(b"data: "):
                    yield json.loads(raw[len(b"data: "):])
    finally:
        resp.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run", help="run name (or directory) to serve")
    src.add_argument("--config", help="model config YAML: serve random "
                                      "weights drawn from --seed")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (the locked path's cache, or the batch "
                        "engine's pool)")
    p.add_argument("--max-tokens-limit", type=int, default=4096)
    p.add_argument("--spec", action="store_true",
                   help="prompt-lookup speculative decoding for greedy/"
                        "temperature requests on the locked path")
    p.add_argument("--draft-len", type=int, default=8)
    p.add_argument("--engine", choices=("locked", "batch"), default="locked",
                   help="locked = one request at a time behind a lock "
                        "(default); batch = the continuous-batching engine "
                        "over the paged KV pool")
    p.add_argument("--slots", type=int, default=8,
                   help="batch engine: concurrent decode slots")
    p.add_argument("--kv-len", type=int, default=2048,
                   help="batch engine: per-request KV length bound (clamped "
                        "to the model's max_position_embeddings)")
    p.add_argument("--max-queue", type=int, default=32,
                   help="batch engine: admission queue depth before 429")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="batch engine: prompt tokens prefilled per iteration")
    p.add_argument("--kv-backend", choices=("paged", "slotted"),
                   default="paged",
                   help="batch engine: paged = block-table KV arena "
                        "(admission by free blocks); slotted = one fixed "
                        "max-len row per request")
    p.add_argument("--block-size", type=int, default=32,
                   help="paged backend: tokens per KV block (power of two; "
                        "kv-len must be a multiple)")
    p.add_argument("--num-blocks", type=int, default=0,
                   help="paged backend: KV arena size in blocks "
                        "(0 = slots * kv_len / block)")
    p.add_argument("--spec-draft-len", type=int, default=0,
                   help="paged backend: in-batch speculative decoding, "
                        "prompt-lookup drafts verified per decode step "
                        "(0 = off)")
    p.add_argument("--spec-max-ngram", type=int, default=3,
                   help="paged backend: longest suffix n-gram for prompt-"
                        "lookup drafting")
    p.add_argument("--weight-dtype", choices=("fp", "int8", "int4"),
                   default="fp",
                   help="batch engine: weight-only quantization of the "
                        "serving weights (models/quantize.py), per-output-"
                        "channel scales, quantized as the checkpoint loads; "
                        "embeddings and norms stay fp")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="batch engine: disable automatic prefix caching")
    p.add_argument("--prefix-min-hit-blocks", type=int, default=1,
                   help="batch engine: shortest cached block-chain worth "
                        "adopting")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="batch engine: default per-request deadline")
    p.add_argument("--trace", action="store_true",
                   help="batch engine: record per-request spans "
                        "(queue_wait/prefill/decode; dump via GET /trace)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="fraction of requests traced (deterministic by trace id)")
    p.add_argument("--stats-url", default=None,
                   help="batch engine: ws:// URL of the obs stats server for "
                        "per-iteration serving metrics")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="batch engine: serve its registry as Prometheus text on "
                        "this port (0 off)")
    p.add_argument("--mesh", default=None,
                   help="batch engine: serving mesh spec, e.g. tp=1,dp=1; a "
                        "mesh of more than one device is not ported (ROADMAP "
                        "queue 1 item 10)")
    p.add_argument("--role", choices=("any", "prefill", "decode"),
                   default="any",
                   help="fleet pool this replica serves (published in "
                        "/metrics; the fleet router routes by it)")
    p.add_argument("--fleet-dir", default=None,
                   help="fleet membership directory (serve/fleet.py): "
                        "register this replica and keep its heartbeat")
    p.add_argument("--fleet-index", type=int, default=0,
                   help="membership slot index under --fleet-dir")
    a = p.parse_args(argv)
    if a.weight_dtype != "fp" and a.engine != "batch":
        p.error("--weight-dtype requires --engine batch")
    if a.mesh and a.engine != "batch":
        p.error("--mesh requires --engine batch")
    if a.mesh:
        EngineConfig(mesh=a.mesh)  # refuses a multi-device mesh before the load

    kw = dict(device=a.device, kv_quant=a.kv_quant,
              max_tokens_limit=a.max_tokens_limit, speculative=a.spec,
              draft_len=a.draft_len)
    service = (InferenceService.from_run(a.run, a.runs_root,
                                         weight_dtype=a.weight_dtype, **kw) if a.run
               else InferenceService.from_config(a.config, seed=a.seed, **kw))
    if a.engine == "batch":
        service.attach_engine(EngineConfig(
            num_slots=a.slots, max_len=a.kv_len, max_queue=a.max_queue,
            prefill_chunk=a.prefill_chunk, kv_quant=a.kv_quant,
            kv_backend=a.kv_backend, block_size=a.block_size,
            num_blocks=a.num_blocks, spec_draft_len=a.spec_draft_len,
            spec_max_ngram=a.spec_max_ngram, weight_dtype=a.weight_dtype,
            prefix_cache=not a.no_prefix_cache,
            prefix_min_hit_blocks=a.prefix_min_hit_blocks,
            default_deadline_s=a.deadline_s, trace=a.trace,
            trace_sample=a.trace_sample, stats_url=a.stats_url,
            metrics_port=a.metrics_port, role=a.role, mesh=a.mesh))
    httpd = ThreadingHTTPServer((a.host, a.port), make_handler(service))
    if a.fleet_dir:
        from ..serve.fleet import start_heartbeat

        start_heartbeat(a.fleet_dir,
                        f"http://{a.host}:{httpd.server_address[1]}",
                        role=a.role, index=a.fleet_index)
    print(f"serving {service.run_name} ({service.n_params / 1e6:.1f}M params, "
          f"engine={a.engine}, role={a.role}, device={a.device}) on "
          f"http://{a.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
