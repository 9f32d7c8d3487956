"""HTTP inference server over the continuous-batching engine.

    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.server \\
        --run myrun --runs-root runs --port 8400
    python -m mlx_cuda_distributed_pretraining_tpu_torch.infer.server \\
        --config configs/model-config-moe-8x40m.yaml --seed 0

    POST /generate {"prompt": "...", "max_tokens": 64, "temperature": 0.8}
      -> {"text": ..., "tokens": N, "token_ids": [...], "logprobs": [...], ...}
    GET /healthz -> {"status": "ok", "params_m": ..., "serve": {metrics}}

Every request goes through the batch engine (serve/engine.py) on the
device the weights live on (``--device``, default ``cuda``). A full
admission queue returns 429, a missed deadline 504. ``top_p``, ``min_p``
and ``repetition_penalty`` reshape logits, which only the JAX package's
locked generation path does; here they are refused with 400 until that path
is ported. Streaming, the OpenAI-style endpoint and the fleet/admin
endpoints are not ported either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..models import llama
from ..serve import BatchEngine, EngineConfig, QueueFullError

_RESHAPING_KNOBS = ("top_p", "min_p", "repetition_penalty")
_NO_OP = {"top_p": (0.0, 1.0), "min_p": (0.0,), "repetition_penalty": (1.0,)}


class InferenceService:
    """Owns the model and the batch engine that serves it."""

    def __init__(self, params, args, tokenizer, run_name: str = "?",
                 max_tokens_limit: int = 4096):
        self.params = params
        self.args = args
        self.tokenizer = tokenizer
        self.run_name = run_name
        self.max_tokens_limit = max_tokens_limit
        self.n_params = llama.num_params(params)
        self.engine: Optional[BatchEngine] = None

    def attach_engine(self, cfg: Optional[EngineConfig] = None) -> BatchEngine:
        """Start the batch engine; ``max_len`` is clamped to the model's
        ``max_position_embeddings`` (EngineConfig's default of 2048 would
        otherwise exceed a 1024-position model)."""
        cfg = cfg or EngineConfig()
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
                 max_tokens_limit: int = 4096) -> "InferenceService":
        from ..train.trainer import load_trained

        params, args, tok, _cfg = load_trained(run, runs_root=runs_root,
                                               device=device)
        return cls(params, args, tok, run_name=run,
                   max_tokens_limit=max_tokens_limit)

    @classmethod
    def from_config(cls, path: str, seed: int = 0, device="cuda",
                    max_tokens_limit: int = 4096) -> "InferenceService":
        """Random weights at a model config's shapes, drawn from ``seed``."""
        import torch

        from ..config import Config
        from ..tokenizer import TokenizerManager

        cfg = Config.from_yaml(path)
        tok = TokenizerManager(cfg.data)
        args = llama.LlamaArgs.from_config(cfg.model, tok.vocab_size)
        params = llama.init_params(args, torch.Generator().manual_seed(seed),
                                   device=device)
        return cls(params, args, tok, run_name=cfg.name,
                   max_tokens_limit=max_tokens_limit)

    def generate(self, prompt: str, max_tokens: int = 64,
                 temperature: float = 0.0, seed: int = 0,
                 deadline_s: Optional[float] = None) -> dict:
        if self.engine is None:
            raise RuntimeError("no engine attached (call attach_engine)")
        max_tokens = max(1, min(int(max_tokens), self.max_tokens_limit))
        out = self.engine.generate(prompt, max_tokens=max_tokens,
                                   temperature=temperature, seed=seed,
                                   deadline_s=deadline_s)
        out["effective_params"] = {"temperature": temperature,
                                   "max_tokens": max_tokens}
        return out

    def health(self) -> dict:
        d = {
            "status": "ok",
            "run": self.run_name,
            "architecture": "llama",
            "params_m": round(self.n_params / 1e6, 2),
            "vocab_size": self.args.vocab_size,
            "max_tokens_limit": self.max_tokens_limit,
            "engine": "batch",
        }
        if self.engine is not None:
            d["serve"] = self.engine.metrics()
        return d


def _refused_knobs(req: dict) -> list:
    """Logit-reshaping knobs the request sets to something other than a
    no-op value."""
    return [k for k in _RESHAPING_KNOBS
            if req.get(k) is not None and float(req[k]) not in _NO_OP[k]]


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

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/healthz"):
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path.rstrip("/") != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict) or "prompt" not in req:
                    raise ValueError("body must be a JSON object with 'prompt'")
                if not isinstance(req["prompt"], str):
                    raise ValueError("'prompt' must be a string")
                refused = _refused_knobs(req)
                if refused:
                    raise ValueError(
                        f"{', '.join(refused)} not supported by the torch "
                        "server yet (the batch engine samples by temperature "
                        "only)")
                if req.get("stream"):
                    raise ValueError("streaming is not supported by the "
                                     "torch server yet")
                dl = req.get("deadline_s")
                out = service.generate(
                    prompt=req["prompt"],
                    max_tokens=int(req.get("max_tokens", 64)),
                    temperature=float(req.get("temperature", 0.0)),
                    seed=int(req.get("seed", 0)),
                    deadline_s=float(dl) if dl is not None else None)
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
    p.add_argument("--max-tokens-limit", type=int, default=4096)
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots")
    p.add_argument("--kv-len", type=int, default=2048,
                   help="per-request KV length bound (clamped to the model's "
                        "max_position_embeddings)")
    p.add_argument("--max-queue", type=int, default=32,
                   help="admission queue depth before 429")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="prompt tokens prefilled per iteration")
    p.add_argument("--block-size", type=int, default=32,
                   help="tokens per KV block (power of two; kv-len must be "
                        "a multiple)")
    p.add_argument("--num-blocks", type=int, default=0,
                   help="KV arena size in blocks (0 = slots * kv_len / block)")
    p.add_argument("--no-prefix-cache", action="store_true",
                   help="disable automatic prefix caching")
    p.add_argument("--prefix-min-hit-blocks", type=int, default=1,
                   help="shortest cached block-chain worth adopting")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline")
    a = p.parse_args(argv)

    if a.run:
        service = InferenceService.from_run(
            a.run, a.runs_root, device=a.device,
            max_tokens_limit=a.max_tokens_limit)
    else:
        service = InferenceService.from_config(
            a.config, seed=a.seed, device=a.device,
            max_tokens_limit=a.max_tokens_limit)
    service.attach_engine(EngineConfig(
        num_slots=a.slots, max_len=a.kv_len, max_queue=a.max_queue,
        prefill_chunk=a.prefill_chunk, block_size=a.block_size,
        num_blocks=a.num_blocks, prefix_cache=not a.no_prefix_cache,
        prefix_min_hit_blocks=a.prefix_min_hit_blocks,
        default_deadline_s=a.deadline_s))
    httpd = ThreadingHTTPServer((a.host, a.port), make_handler(service))
    print(f"serving {service.run_name} ({service.n_params / 1e6:.1f}M params, "
          f"device={a.device}) on http://{a.host}:{httpd.server_address[1]}")
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
