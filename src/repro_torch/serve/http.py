"""Minimal stdlib HTTP shim over the async serving front-end.

The port of ``repro/serve/http.py``.  No web framework:
``http.server.ThreadingHTTPServer`` + ``json`` over the existing
``AsyncFrontend``.  Two endpoints:

  * ``POST /generate`` — JSON body ``{"prompt": [ids...], "max_tokens":
    N, ...}`` (see :func:`request_from_payload` for the accepted
    fields); blocks until the request reaches a terminal status and
    returns ``{"status", "tokens", "finish_reason", "ttft_s",
    "request_id"}``.  A malformed body is answered with 400.
  * ``GET /metrics`` — the cluster's Prometheus exposition (content
    type ``text/plain; version=0.0.4``), including the dispatch
    telemetry and latency-histogram families from ``repro_torch.obs``.

``HttpFrontend`` owns the plumbing: a daemon thread runs an asyncio loop
hosting the ``AsyncFrontend``; HTTP handler threads hop onto that loop
with ``asyncio.run_coroutine_threadsafe``.  The router is still only ever
touched by the frontend's single background task, so the no-locking
invariant holds no matter how many HTTP clients connect.

Run a toy server (random weights from seed 0; on the card unless
``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.serve.http --arch smollm-135m \
        --reduced --device cpu --port 8080
"""
from __future__ import annotations

import asyncio
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.serve.cluster import EngineRouter
from repro_torch.serve.frontend import AsyncFrontend, RequestResult
from repro_torch.serve.scheduler import Request

_REQUEST_FIELDS = ("prompt", "max_tokens", "temperature", "top_k",
                   "stop_tokens", "priority", "tier", "deadline_s")


def request_from_payload(payload: dict) -> tuple[Request, Optional[str],
                                                 Optional[float]]:
    """Validate a ``/generate`` JSON body into ``(Request, tier,
    deadline_s)``; raises ``ValueError`` with a client-safe message."""
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    unknown = set(payload) - set(_REQUEST_FIELDS)
    if unknown:
        raise ValueError(f"unknown fields: {sorted(unknown)}")
    prompt = payload.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) for t in prompt)):
        raise ValueError("prompt must be a non-empty list of token ids")
    max_tokens = payload.get("max_tokens", 16)
    if not isinstance(max_tokens, int) or max_tokens < 1:
        raise ValueError("max_tokens must be a positive integer")
    stop = payload.get("stop_tokens")
    if stop is not None and (not isinstance(stop, list) or
                             not all(isinstance(t, int) for t in stop)):
        raise ValueError("stop_tokens must be a list of token ids")
    tier = payload.get("tier")
    if tier is not None and not isinstance(tier, str):
        raise ValueError("tier must be a string")
    deadline_s = payload.get("deadline_s")
    if deadline_s is not None and not isinstance(deadline_s, (int, float)):
        raise ValueError("deadline_s must be a number")
    req = Request(prompt=list(prompt), max_tokens=max_tokens,
                  temperature=float(payload.get("temperature", 0.0)),
                  top_k=int(payload.get("top_k", 0)),
                  stop_tokens=None if stop is None else tuple(stop),
                  priority=float(payload.get("priority", 0.0)))
    return req, tier, deadline_s


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries the HttpFrontend (see _Server below)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # quiet by default
        if self.server.hf.verbose:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: dict) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path.split("?")[0] != "/metrics":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        text = self.server.hf.router.metrics().to_prometheus()
        self._send(200, text.encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def do_POST(self):
        if self.path.split("?")[0] != "/generate":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            req, tier, deadline_s = request_from_payload(payload)
        except (ValueError, json.JSONDecodeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        try:
            rid, result = self.server.hf.generate(req, tier=tier,
                                                  deadline_s=deadline_s)
        except RuntimeError as exc:
            self._send_json(503, {"error": str(exc)})
            return
        ticket = self.server.hf.router.tickets.get(rid)
        self._send_json(200, {
            "status": result.status,
            "tokens": result.tokens,
            "finish_reason": result.finish_reason,
            "ttft_s": ticket.ttft_s if ticket is not None else None,
            "request_id": rid,
        })


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, hf: "HttpFrontend"):
        self.hf = hf
        super().__init__(addr, _Handler)


class HttpFrontend:
    """Serve an ``EngineRouter`` over HTTP; see the module docstring.

    ``start()`` spins up (1) a daemon thread running an asyncio loop
    that hosts the ``AsyncFrontend`` and (2) the threading HTTP server;
    ``stop()`` drains and tears both down.  ``port=0`` binds an
    ephemeral port (read it back from ``.port`` — handy for tests).
    """

    def __init__(self, router: EngineRouter, *, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False):
        self.router = router
        self.host = host
        self.port = port
        self.verbose = verbose
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._frontend: Optional[AsyncFrontend] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._httpd: Optional[_Server] = None
        self._http_thread: Optional[threading.Thread] = None

    # ---------------- lifecycle ----------------

    def start(self) -> "HttpFrontend":
        if self._loop is not None:
            raise RuntimeError("already started")
        started = threading.Event()

        def run_loop():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            started.set()
            loop.run_forever()
            loop.close()

        self._loop_thread = threading.Thread(target=run_loop,
                                             name="http-frontend-loop",
                                             daemon=True)
        self._loop_thread.start()
        started.wait()

        async def boot():
            fe = AsyncFrontend(self.router)
            await fe.start()
            return fe

        self._frontend = asyncio.run_coroutine_threadsafe(
            boot(), self._loop).result()
        self._httpd = _Server((self.host, self.port), self)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-frontend-server",
            daemon=True)
        self._http_thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._frontend is not None and self._loop is not None:
            asyncio.run_coroutine_threadsafe(
                self._frontend.stop(drain=drain), self._loop).result()
            self._frontend = None
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join()
            self._loop = None
            self._loop_thread = None

    def __enter__(self) -> "HttpFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---------------- request bridge ----------------

    def generate(self, request: Request, *, tier: str | None = None,
                 deadline_s: float | None = None
                 ) -> tuple[int, RequestResult]:
        """Submit and block until terminal (handler-thread entry point)."""
        if self._loop is None or self._frontend is None:
            raise RuntimeError("frontend is not running")

        async def run():
            handle = await self._frontend.submit(request, tier=tier,
                                                 deadline_s=deadline_s)
            result = await handle
            return handle.request_id, result

        return asyncio.run_coroutine_threadsafe(run(), self._loop).result()


def main(argv=None) -> None:
    import argparse

    import torch

    from repro_torch import configs
    from repro_torch.models import api as model_api
    from repro_torch.serve.cluster import EngineReplica
    from repro_torch.serve.engine import ContinuousEngine, PoolConfig

    p = argparse.ArgumentParser(
        description="toy HTTP serving front-end (stdlib only)")
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action="store_true",
                   help="shrink the config (toy weights)")
    p.add_argument("--device", default="cuda",
                   help="where the weights and pools live (cuda or cpu)")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--n-slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = model_api.init_params(cfg, gen, device=args.device)
    pool = PoolConfig(n_slots=args.n_slots, max_len=args.max_len)
    replicas = [
        EngineReplica(name=f"r{i}", engine=ContinuousEngine(
            cfg, params, pool, device=args.device))
        for i in range(args.replicas)
    ]
    router = EngineRouter(replicas)
    hf = HttpFrontend(router, host=args.host, port=args.port,
                      verbose=args.verbose)
    hf.start()
    print(f"serving {args.arch} on {hf.url}  "
          f"(POST /generate, GET /metrics; ctrl-c to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        hf.stop()


if __name__ == "__main__":
    main()
