"""Batched LM serving over ``generate`` (counterpart of
``bigdl_tpu/models/lm_server.py``).

``LMServer`` collects requests into micro-batches: a worker thread takes the
oldest request, waits up to ``batch_timeout_ms`` for company of the same
prompt length (the causal prefill has no padding mask), pads the batch to a
power of two with copies of its first row, and decodes the batch with one
``generate`` call of the server's ``max_new_tokens``. Requests displaced by
a length mismatch are held and anchor the next batches in arrival order, so
no length starves another. ``make_http_server`` puts a stdlib JSON endpoint
in front (``POST /generate``, ``GET /health``); ``/metrics`` waits for the
telemetry port (ROADMAP A7).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device
from bigdl_tpu_torch.utils.util import pow2_bucket


@dataclass
class _Request:
    ids: List[int]                      # 1-based prompt token ids
    max_new: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[int]] = None  # continuation ids (1-based)
    error: Optional[str] = None


def fail_requests(reqs, message: str) -> None:
    """Fail stranded requests: set the error and release every blocked
    ``submit()``. Shared by both servers (this batcher and
    ``models/serving.py``)."""
    for req in reqs:
        req.error = message
        req.done.set()


def drain_queue(q: "queue.Queue") -> list:
    """Empty a request queue without blocking; returns the drained items."""
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


class LMServer:
    """Micro-batching front end over ``models.generation.generate``.

    ``submit()`` blocks until the request's batch has decoded and returns the
    continuation ids (prompt excluded, eos kept, pad stripped). Thread-safe;
    one worker thread owns the model. Batch ``n`` samples from a generator
    seeded with ``(seed, n)``."""

    def __init__(self, model, *, max_batch: int = 8,
                 batch_timeout_ms: float = 20.0, max_new_tokens: int = 64,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                 greedy: bool = False, eos_id: Optional[int] = None,
                 seed: int = 0, device: DeviceLike = "cuda"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = check_module_device(model, device)
        self.model = model
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.max_new_tokens = max_new_tokens
        self.sampling = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p, greedy=greedy, eos_id=eos_id)
        self._seed = seed
        self._n_batches = 0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # held requests are rewritten by the worker and by close(): every
        # mutation holds _held_lock
        self._held_lock = threading.Lock()
        self._held: List[_Request] = []
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="lm-server-batcher")
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, prompt_ids, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None) -> List[int]:
        """Serve one prompt; returns its continuation ids (1-based)."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        max_new = int(self.max_new_tokens if max_new_tokens is None
                      else max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if max_new > self.max_new_tokens:
            raise ValueError(f"max_new_tokens {max_new} exceeds the "
                             f"server's decode budget {self.max_new_tokens}")
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        req = _Request(ids, max_new)
        self._queue.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("decode did not complete in time")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    @property
    def queue_depth(self) -> int:
        """Requests queued plus those held for same-length company."""
        return self._queue.qsize() + len(self._held)

    @property
    def batches_served(self) -> int:
        return self._n_batches

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=30)
        with self._held_lock:
            stranded, self._held = self._held, []
        fail_requests(stranded + drain_queue(self._queue),
              "server closed before the request was dispatched")

    # ---------------------------------------------------------------- batcher
    def _gather(self) -> Optional[List[_Request]]:
        """The oldest request (held ones first) plus up-to-timeout company
        of the same prompt length."""
        with self._held_lock:
            first = self._held.pop(0) if self._held else None
        if first is None:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return None
        batch = [first]
        s = len(first.ids)
        with self._held_lock:
            still_held = []
            for req in self._held:
                if len(req.ids) == s and len(batch) < self.max_batch:
                    batch.append(req)
                else:
                    still_held.append(req)
            self._held = still_held
        deadline = time.monotonic() + self.batch_timeout
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if len(req.ids) == s:
                batch.append(req)
            else:
                with self._held_lock:
                    self._held.append(req)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if not batch:
                continue
            try:
                self._decode_batch(batch)
            except Exception as e:  # surface to every waiter, keep serving
                fail_requests(batch, f"{type(e).__name__}: {e}")
        with self._held_lock:
            stranded, self._held = self._held, []
        fail_requests(stranded + drain_queue(self._queue),
              "server closed before the request was dispatched")

    def _decode_batch(self, batch: List[_Request]) -> None:
        from bigdl_tpu_torch.models.generation import generate
        s = len(batch[0].ids)
        b = pow2_bucket(len(batch), 1, self.max_batch)
        rows = [req.ids for req in batch]
        rows += [rows[0]] * (b - len(rows))
        prompt = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        seed = int(np.random.SeedSequence([self._seed, self._n_batches])
                   .generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = generate(self.model, prompt, self.max_new_tokens, generator=gen,
                       device=self.device, **self.sampling).cpu().numpy()
        self._n_batches += 1
        eos = self.sampling["eos_id"]
        for i, req in enumerate(batch):
            cont = out[i, s:s + req.max_new].tolist()
            if eos is not None and eos in cont:
                cont = cont[:cont.index(eos) + 1]  # keep eos, strip the pad
            req.result = cont
            req.done.set()


def make_http_server(server, host: str, port: int):
    """Stdlib ``ThreadingHTTPServer`` speaking JSON in front of an
    ``LMServer`` or a ``ContinuousLMServer``:

    POST /generate  {"prompt": [ids...]}, optional "max_new_tokens"
                    -> {"ids": [...]}
    GET  /health    -> {"ok": true, "batches_served": N, "queue_depth": N};
                    503 with "dead": reason or "draining": reason once a
                    continuous server has died or is draining, so that an
                    orchestrator stops routing to it

    Text prompts (the reference's ``tokenizer``) wait for the tokenizer
    port (ROADMAP A8)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; the caller logs
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                return self._reply(404, {
                    "error": "GET /health (/metrics waits for the telemetry "
                             "port)"})
            dead = getattr(server, "dead_reason", None)
            draining = getattr(server, "drain_reason", None)
            self._reply(503 if (dead or draining) else 200,
                        {"ok": dead is None and draining is None,
                         "batches_served": server.batches_served,
                         "queue_depth": server.queue_depth,
                         **({"dead": dead} if dead else {}),
                         **({"draining": draining}
                            if (draining and not dead) else {})})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "POST /generate only"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if "prompt" not in body:
                    return self._reply(400, {"error": "missing 'prompt' (ids)"})
                ids = [int(t) for t in body["prompt"]]
                cont = server.submit(ids, body.get("max_new_tokens"))
            except (ValueError, KeyError, TypeError) as e:
                return self._reply(400, {"error": str(e)})
            except Exception as e:  # boundary: report, keep serving
                return self._reply(500, {"error": str(e)})
            self._reply(200, {"ids": cont})

    return ThreadingHTTPServer((host, port), Handler)
