"""HTTP serving over continuous batching (PyTorch counterpart of the core of
luminaai_tpu/serving/server.py).

A ContinuousScheduler owns the step-wise decode loop over the slot-paged
KV pool on ONE worker thread: every tick it admits queued requests into
free slots (whole-prompt prefill, or chunked prefill advanced one chunk per
tick so a long prompt never stalls the decode batch for more than a
chunk), runs one decode step for all active lanes, and finishes lanes on a
stop token or their length budget. Every device call happens on that
thread; HTTP handler threads only enqueue requests and wait.

Endpoints (a ThreadingHTTPServer, stdlib only):
  GET  /health        liveness + model info
  GET  /stats         request/token counters + scheduler and pool state
  POST /v1/generate   {"prompt": str, "max_new_tokens"?, "temperature"?,
                       "top_p"?, "top_k"?, "repetition_penalty"?, "seed"?}
                       -> {"text", "tokens", "latency_s", "stopped"}
  POST /v1/chat       {"messages": [{"role","content"}...]} or
                      {"message": str} -> {"reply", ...}

The JAX server's telemetry, SLOs, watchdog, authentication, tenant queues,
deadlines, SSE streaming, page sharing and MicroBatcher are not part of
this slice.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20


class _ContinuousRequest:
    """One request inside the scheduler: prompt, budgets, result sink."""

    def __init__(self, prompt, max_new, sample_key, seed):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.sample_key = sample_key
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.tokens: List[int] = []
        self.done = False
        self.slot: Optional[int] = None
        self.prompt_tokens = 0
        self.admitted_step: Optional[int] = None
        self.t0 = time.time()


class ContinuousScheduler:
    """Continuous (in-flight) batching over a slot-paged KV pool.

    Sampling parameters are one key per generation: a request with another
    key parks in `_pending`, admissions pause, the active lanes drain, and
    the scheduler switches keys.
    """

    _STOP = object()  # close() sentinel

    def __init__(self, engine, num_slots: int = 8, page_size: int = 128):
        self.engine = engine
        self.decoder = engine.make_stepwise(
            num_slots=num_slots, page_size=page_size
        )
        # slot -> (request, chunk state); advanced one chunk per tick.
        self._prefilling: Dict[int, Tuple[_ContinuousRequest, Any]] = {}
        self.q: "queue.Queue" = queue.Queue()
        self._pending: List[_ContinuousRequest] = []
        self.batches = 0
        self.max_batch_seen = 0
        self.requests_served = 0
        self.decode_seconds = 0.0  # wall time inside decode steps
        self._active_lanes = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public API --------------------------------------------------------
    def submit(
        self, prompt_tokens: List[int], gen_kwargs: Dict[str, Any]
    ) -> Tuple[List[int], Dict[str, Any]]:
        """Block until the request finishes; returns (tokens, stats)."""
        req = self._make_request(prompt_tokens, gen_kwargs)
        self.q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker after the work already queued."""
        self.q.put(self._STOP)
        self._worker.join(timeout)

    def queue_depth(self) -> int:
        return self.q.qsize() + len(self._pending)

    def stats(self) -> Dict[str, Any]:
        return {
            "scheduler": "continuous",
            "batches": self.batches,
            "max_batch_seen": self.max_batch_seen,
            "decode_steps": int(self.decoder.steps),
            "decode_seconds": round(self.decode_seconds, 6),
            "active_lanes": self._active_lanes,
            "queue_depth": self.queue_depth(),
            "prefilling": len(self._prefilling),
            "kv_pool": self.decoder.pool.stats(),
        }

    # -- internals ---------------------------------------------------------
    def _make_request(self, prompt_tokens, gen_kwargs):
        key = self.engine._resolve_gen_key(
            gen_kwargs.get("max_new_tokens"),
            gen_kwargs.get("temperature"),
            gen_kwargs.get("top_p"),
            gen_kwargs.get("top_k"),
            gen_kwargs.get("repetition_penalty"),
        )
        max_new, sample_key = key[0], tuple(key[1:])
        # A slot holds prompt tail + budget: the prompt trims, the budget
        # clamps to the decoder's token capacity.
        max_new = max(1, min(max_new, int(self.decoder.token_capacity) - 1))
        return _ContinuousRequest(
            prompt_tokens, max_new, sample_key, gen_kwargs.get("seed")
        )

    def _finish(self, req: _ContinuousRequest, stopped: str) -> None:
        if req.done:
            return
        dt = time.time() - req.t0
        n = len(req.tokens)
        stats = {
            "tokens_generated": n,
            "seconds": round(dt, 3),
            "tokens_per_second": round(n / max(dt, 1e-9), 1),
            "prompt_tokens": req.prompt_tokens,
            "stopped": stopped,
            "slot": req.slot,
            "admitted_step": req.admitted_step,
            "finished_step": int(self.decoder.steps),
            "scheduler": "continuous",
        }
        self.requests_served += 1
        req.done = True
        req.result = (req.tokens, stats)
        req.event.set()

    def _fail(self, req: _ContinuousRequest, err: BaseException) -> None:
        if req.done:
            return
        req.done = True
        req.error = err
        req.event.set()

    def _release(self, req: _ContinuousRequest, active: dict) -> None:
        self.decoder.release_slot(req.slot)
        active.pop(req.slot, None)
        self._active_lanes = len(active)

    def _admit(self, req: _ContinuousRequest, active: dict) -> None:
        """Prefill-then-join: chunked when the decoder chunks this prompt
        (advanced from the loop), else one whole-prompt prefill now."""
        slot = self.decoder.acquire_slot()
        try:
            st = self.decoder.start_prefill(
                slot, req.prompt, max_new_tokens=req.max_new,
                sample_key=req.sample_key, seed=req.seed,
            )
            if st is not None:
                self._prefilling[slot] = (req, st)
                return
            info = self.decoder.prefill_into_slot(
                slot, req.prompt, max_new_tokens=req.max_new,
                sample_key=req.sample_key, seed=req.seed,
            )
        except Exception as e:
            logger.exception("prefill failed")
            self.decoder.release_slot(slot)
            self._fail(req, e)
            return
        self._prefill_done(req, slot, info, active)

    def _prefill_done(self, req, slot, info, active) -> None:
        """First token out, lane joins the decode batch (or finishes)."""
        req.slot = slot
        req.prompt_tokens = int(info.get("prompt_tokens", 0))
        req.admitted_step = int(self.decoder.steps)
        if info.get("is_stop"):
            self._finish(req, "eos")
            self.decoder.release_slot(slot)
            return
        req.tokens.append(int(info["token"]))
        if req.max_new <= 1:
            self._finish(req, "length")
            self.decoder.release_slot(slot)
            return
        active[slot] = req
        self._active_lanes = len(active)
        self.max_batch_seen = max(self.max_batch_seen, len(active))

    def _admit_queued(self, key, active: dict) -> None:
        """Admit queued same-key requests into free slots; a mismatched key
        parks and pauses admission until the batch drains."""
        while self.decoder.has_free_slot() and not self._pending:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                return
            if nxt is self._STOP:
                self._pending.append(nxt)
            elif nxt.sample_key == key:
                self._admit(nxt, active)
            else:
                self._pending.append(nxt)

    def _advance_prefills(self, active: dict) -> None:
        """Advance ONE chunk of ONE mid-prefill admission (round-robin)."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        req, st = self._prefilling.pop(slot)
        try:
            info = self.decoder.advance_prefill(st)
        except Exception as e:
            logger.exception("chunked prefill failed")
            self.decoder.release_slot(slot)
            self._fail(req, e)
            return
        if info is None:
            self._prefilling[slot] = (req, st)  # back of the ring
            return
        self._prefill_done(req, slot, info, active)

    def _loop(self) -> None:
        while True:
            req = self._pending.pop(0) if self._pending else self.q.get()
            if req is self._STOP:
                return
            try:
                self._run_generation(req)
            except Exception as e:  # never kill the worker
                logger.exception("generation failed")
                self._fail(req, e)

    def _run_generation(self, first: _ContinuousRequest) -> None:
        self.batches += 1
        key = first.sample_key
        active: Dict[int, _ContinuousRequest] = {}
        self._admit(first, active)
        while active or self._prefilling:
            self._admit_queued(key, active)
            self._advance_prefills(active)
            if not active:
                continue
            try:
                t_step = time.perf_counter()
                # decode_step ends reading the sampled tokens back, so the
                # host clock spans the device work of the step.
                toks, produced, eos = self.decoder.decode_step(key)
                self.decode_seconds += time.perf_counter() - t_step
            except Exception as e:
                logger.exception("decode step failed")
                for r in list(active.values()):
                    self._fail(r, e)
                    self._release(r, active)
                for slot, (r, _) in list(self._prefilling.items()):
                    self._fail(r, e)
                    self.decoder.release_slot(slot)
                self._prefilling.clear()
                return
            for slot, r in list(active.items()):
                if eos[slot]:
                    self._finish(r, "eos")
                    self._release(r, active)
                elif produced[slot]:
                    r.tokens.append(int(toks[slot]))
                    if len(r.tokens) >= r.max_new or self.decoder.lane_full(
                        slot
                    ):
                        self._finish(r, "length")
                        self._release(r, active)


class ChatServer:
    """Owns the engine and the scheduler; builds the HTTP handler."""

    # (name, clamp): requests cannot push sampling parameters outside sane
    # bounds, and max_new_tokens is capped at MAX_NEW_TOKENS_CAP.
    MAX_NEW_TOKENS_CAP = 2048
    _OVERRIDE_CLAMPS = {
        "max_new_tokens": lambda v, cap: max(1, min(int(v), cap)),
        "temperature": lambda v, _: min(max(float(v), 0.0), 10.0),
        "top_p": lambda v, _: min(max(float(v), 0.0), 1.0),
        "top_k": lambda v, _: max(0, min(int(v), 10_000)),
        "repetition_penalty": lambda v, _: min(max(float(v), 0.5), 5.0),
    }

    def __init__(self, engine, num_slots: int = 8, page_size: int = 128):
        self.engine = engine
        self.batcher = ContinuousScheduler(
            engine, num_slots=num_slots, page_size=page_size
        )
        self.state_lock = threading.Lock()
        self.t0 = time.time()
        self.requests = 0
        self.tokens_out = 0

    def close(self) -> None:
        self.batcher.close()

    # -- request handling --------------------------------------------------
    def handle(self, method: str, path: str, body: Dict[str, Any]) -> tuple:
        """Returns (status_code, payload dict). No socket I/O."""
        if method == "GET" and path == "/health":
            cfg = self.engine.config
            return 200, {
                "status": "ok",
                "uptime_s": round(time.time() - self.t0, 1),
                "model": {
                    "hidden_size": cfg.hidden_size,
                    "num_layers": cfg.num_layers,
                    "vocab_size": cfg.vocab_size,
                    "moe": bool(cfg.use_moe),
                },
                "device": str(self.engine.model.device),
            }
        if method == "GET" and path == "/stats":
            with self.state_lock:
                out = {
                    "requests": self.requests,
                    "tokens_out": self.tokens_out,
                    "uptime_s": round(time.time() - self.t0, 1),
                }
            out.update(self.batcher.stats())
            return 200, out
        if method == "POST" and path in ("/v1/generate", "/v1/chat"):
            return self._run_model(path, body)
        return 404, {"error": f"no route {method} {path}"}

    def _parse_request(self, path: str, body: Dict[str, Any]):
        """Returns (error_tuple | None, prompt_ids, overrides, reply_key)."""
        overrides = {}
        for k, clamp in self._OVERRIDE_CLAMPS.items():
            if k in body:
                try:
                    overrides[k] = clamp(body[k], self.MAX_NEW_TOKENS_CAP)
                except (TypeError, ValueError):
                    return (400, {"error": f"bad value for {k}"}), None, None, None
        if "seed" in body:
            try:
                overrides["seed"] = int(body["seed"]) & 0xFFFFFFFF
            except (TypeError, ValueError):
                return (400, {"error": "bad value for seed"}), None, None, None
        if path == "/v1/chat":
            messages = body.get("messages")
            if not messages:
                msg = str(body.get("message", ""))
                if not msg:
                    return (400, {"error": "message(s) required"}), None, None, None
                messages = [{"role": "user", "content": msg}]
            for m in messages:
                if (
                    not isinstance(m, dict)
                    or not isinstance(m.get("role"), str)
                    or not isinstance(m.get("content"), str)
                ):
                    return (400, {
                        "error": "each message needs string 'role' and "
                                 "'content'"
                    }), None, None, None
            return None, self.engine.encode_chat(messages), overrides, "reply"
        prompt = str(body.get("prompt", ""))
        if not prompt:
            return (400, {"error": "prompt required"}), None, None, None
        return None, self.engine.tokenizer.backend.encode(prompt), overrides, "text"

    def _run_model(self, path: str, body: Dict[str, Any]) -> tuple:
        t0 = time.time()
        err, prompt_ids, overrides, reply_key = self._parse_request(path, body)
        if err is not None:
            return err
        tokens, stats = self.batcher.submit(prompt_ids, overrides)
        n_tok = int(stats.get("tokens_generated", 0))
        with self.state_lock:
            self.requests += 1
            self.tokens_out += n_tok
        return 200, {
            reply_key: self.engine.tokenizer.decode(tokens),
            "tokens": n_tok,
            "token_ids": [int(t) for t in tokens],
            "prompt_tokens": stats.get("prompt_tokens"),
            "latency_s": round(time.time() - t0, 3),
            "stopped": stats.get("stopped"),
        }

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # to logging, not stderr
                logger.info("%s %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.partition("?")[0]
                self._reply(*server.handle("GET", path, {}))

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        self._reply(413, {"error": "body too large"})
                        return
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                path = self.path.split("?", 1)[0]
                try:
                    code, payload = server.handle("POST", path, body)
                except Exception as e:  # surface as 500, keep serving
                    logger.exception("request failed")
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload)

        return Handler

    def make_httpd(self, host: str = "127.0.0.1", port: int = 5001):
        """The HTTP server bound to (host, port); port 0 picks a free one
        (read it back from `httpd.server_address`)."""
        return ThreadingHTTPServer((host, port), self.make_handler())

    def serve_forever(self, host: str = "127.0.0.1", port: int = 5001):
        httpd = self.make_httpd(host, port)
        logger.info("serving on http://%s:%d", *httpd.server_address[:2])
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            self.close()
