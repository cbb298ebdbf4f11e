"""Continuous-batching serving layer over the batched inference path (the
port of ``ufvideo_tpu/serve.py``).

``mm_infer_batch`` runs B requests through one encode, one generate and one
SAM2 propagation, so a batch amortises the decode's weight traffic across
requests. This module turns that batched path into a service: a scheduler
that coalesces concurrent requests into compatible batches, plus a stdlib
HTTP front end (JSON replies, server-sent events for streams).

Design notes:
- Requests are grouped by a *compatibility key*: everything that must be
  shared across one ``mm_infer_batch`` call (modal, choice, frame count,
  SAM frame count, generation keywords). The scheduler never mixes them
  inside one dispatch.
- One worker thread owns the card: every device call runs on it, on its
  default stream and with autograd off. The kernel wrappers keep Python
  state (``last_split``, ``last_plan``, launch counts) and the quantised
  products cache scratch per current stream, which is thread-local, so the
  HTTP handler threads do host work only (JSON, base64, RLE, video decode).
- A failed batch retries each sample alone, so one poisoned request cannot
  take down its batchmates; ``stats()`` counts the retried samples
  (``fallback_samples``) and the failures (``errors``).
"""

from __future__ import annotations

import base64
import io
import json
import queue as queue_mod
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import rle
from .api import mm_infer_batch, mm_infer_stream

__all__ = [
    "BatchingScheduler",
    "ServeFuture",
    "StreamFuture",
    "serve_http",
]


class ServeFuture:
    """Minimal synchronous future for one request's result."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._result = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self._exception is not None:
            raise self._exception
        return self._result


class StreamFuture:
    """Iterator over one streaming request's text deltas. The worker pushes
    deltas as decode chunks complete; iterating blocks until the next delta
    or completion (raising the producer's error, if any). ``cancel()`` (on
    client disconnect) makes the worker stop dispatching decode chunks
    after the current one."""

    _DONE = object()

    def __init__(self) -> None:
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._error: Optional[BaseException] = None
        self.cancelled = False

    def push(self, delta: str) -> None:
        self._q.put(delta)

    def finish(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self._q.put(self._DONE)

    def cancel(self) -> None:
        self.cancelled = True

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item


@dataclass
class _Request:
    sample: Dict[str, Any]
    modal: str
    choice: int
    gen: Dict[str, Any]
    future: Any  # ServeFuture | StreamFuture
    stream: bool = False
    t_enqueue: float = field(default_factory=time.perf_counter)


def _batch_key(req: _Request) -> Tuple:
    """Everything that must be homogeneous inside one mm_infer_batch call.

    - modal / choice change prompt assembly;
    - the video frame count and the SAM frame count are shared batch dims
      (mm_infer_batch stacks them); ``len`` reads them from numpy arrays and
      from tensors on any device alike;
    - generation keywords are per-call scalars;
    - the seed only matters under sampling, so greedy requests with
      different seeds still share a batch.
    """
    if req.stream:
        # streams never share a dispatch: their tokens surface per chunk
        return ("stream", id(req))
    g = req.gen
    video = req.sample.get("video")
    sam = req.sample.get("images_sam")
    do_sample = bool(g.get("do_sample", False))
    return (
        req.modal,
        req.choice,
        None if video is None else len(video),
        None if sam is None else len(sam),
        int(g.get("max_new_tokens", 1024)),
        do_sample,
        float(g.get("temperature", 1.0)) if do_sample else None,
        float(g.get("top_p", 0.9)) if do_sample else None,
        int(g.get("seed", 0)) if do_sample else None,
        tuple(g.get("stop_strings") or ()),
    )


class BatchingScheduler:
    """Coalesce concurrent requests into compatible batches on one worker.

    ``submit`` is thread-safe and returns a :class:`ServeFuture`. The worker
    wakes on the first pending request, waits up to ``max_wait_ms`` for
    batchmates (skipped when the queue already holds ``max_batch``
    compatible requests), then dispatches every pending group, oldest first.
    """

    def __init__(
        self,
        model,
        tokenizer,
        max_batch: int = 8,
        max_wait_ms: float = 50.0,
        max_queue: int = 256,
    ) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pending: deque[_Request] = deque()
        self._closing = False
        self.stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_samples": 0,
            "fallback_samples": 0,
            "streamed": 0,
            "errors": 0,
        }
        self._latencies: deque[float] = deque(maxlen=512)
        self._worker = threading.Thread(
            target=self._run, name="ufvideo-serve-worker", daemon=True
        )
        self._worker.start()

    # ---------------- client side ----------------

    def _enqueue(self, req: _Request) -> None:
        with self._wake:
            if self._closing:
                raise RuntimeError("scheduler is closed")
            if len(self._pending) >= self.max_queue:
                raise RuntimeError(f"queue full ({self.max_queue} pending requests)")
            self._pending.append(req)
            self._wake.notify()

    def submit(
        self,
        sample: Dict[str, Any],
        modal: str = "video",
        choice: int = 1,
        **gen_kwargs,
    ) -> ServeFuture:
        """Enqueue one request (the sample contract of ``mm_infer_batch``:
        frames as numpy arrays or as tensors on the CPU or the card).

        Returns a future resolving to the per-sample ``mm_infer_batch``
        result: ``(text, out_dict)`` for path A, ``(None, out_dict)`` for
        path B.
        """
        fut = ServeFuture()
        self._enqueue(_Request(dict(sample), modal, int(choice), dict(gen_kwargs), fut))
        return fut

    def submit_stream(
        self,
        sample: Dict[str, Any],
        modal: str = "video",
        choice: int = 1,
        **gen_kwargs,
    ) -> StreamFuture:
        """Enqueue a streaming request (QA path only, see
        ``api.mm_infer_stream``). Returns an iterator over text deltas."""
        fut = StreamFuture()
        self._enqueue(_Request(dict(sample), modal, int(choice), dict(gen_kwargs), fut,
                               stream=True))
        return fut

    def stats(self) -> Dict[str, Any]:
        with self.stats_lock:
            s = dict(self._stats)
            lat = sorted(self._latencies)
        s["mean_batch_size"] = (
            s["batched_samples"] / s["batches"] if s["batches"] else 0.0
        )
        if lat:
            s["latency_s"] = {
                "p50": round(lat[len(lat) // 2], 4),
                "p95": round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 4),
                "mean": round(sum(lat) / len(lat), 4),
            }
        with self._lock:
            s["pending"] = len(self._pending)
        return s

    def _record_latency(self, reqs) -> None:
        now = time.perf_counter()
        with self.stats_lock:
            for r in reqs:
                self._latencies.append(now - r.t_enqueue)

    def _count(self, **deltas) -> None:
        with self.stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def close(self, timeout: float = 60.0) -> None:
        """Stop intake, drain already-queued requests, join the worker."""
        with self._wake:
            if self._closing:
                return
            self._closing = True
            self._wake.notify()
        self._worker.join(timeout)

    def __enter__(self) -> "BatchingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------- worker side ----------------

    def _take_groups(self) -> List[List[_Request]]:
        """Wait for work, apply the batching window, pop ALL pending
        requests grouped by compatibility key (FIFO by oldest member)."""
        with self._wake:
            while not self._pending and not self._closing:
                self._wake.wait(timeout=0.1)
            if not self._pending:
                return []
            head_key = _batch_key(self._pending[0])
            compat = sum(1 for r in self._pending if _batch_key(r) == head_key)
            deadline = self._pending[0].t_enqueue + self.max_wait_s
            # wait for batchmates unless the head group is already full, the
            # head can never gain any (streams have unique keys), or we are
            # draining for close()
            while (
                compat < self.max_batch
                and not self._pending[0].stream
                and not self._closing
                and time.perf_counter() < deadline
            ):
                self._wake.wait(timeout=max(deadline - time.perf_counter(), 0))
                compat = sum(1 for r in self._pending if _batch_key(r) == head_key)
            taken = list(self._pending)
            self._pending.clear()
        groups: Dict[Tuple, List[_Request]] = {}
        for r in taken:  # dicts keep insertion order: oldest group first
            groups.setdefault(_batch_key(r), []).append(r)
        return [g[i : i + self.max_batch] for g in groups.values()
                for i in range(0, len(g), self.max_batch)]

    def _run(self) -> None:
        # grad mode is per thread: the worker's device calls build no graph
        with torch.no_grad():
            while True:
                groups = self._take_groups()
                if not groups:
                    with self._lock:
                        if self._closing and not self._pending:
                            return
                    continue
                for g in groups:
                    if g[0].stream:
                        self._dispatch_stream(g[0])
                    else:
                        self._dispatch(g)

    def _dispatch_stream(self, req: _Request) -> None:
        s = req.sample
        gen = dict(req.gen)
        chunk = int(gen.pop("chunk", 16))
        try:
            deltas = mm_infer_stream(
                s.get("video"), s["instruct"], self.model, self.tokenizer,
                modal=req.modal, choice=req.choice,
                masks=s.get("masks"), ann_indices=s.get("ann_indices"),
                frame=s.get("frame"), chunk=chunk, **gen,
            )
            try:
                for delta in deltas:
                    if req.future.cancelled:
                        break  # the consumer went away
                    req.future.push(delta)
            finally:
                # closing the generator now, not when it is collected, stops
                # its decode dispatches after the current chunk
                deltas.close()
            self._count(requests=1, streamed=1)
            self._record_latency([req])
            req.future.finish()
        except Exception as e:  # noqa: BLE001 — delivered to the consumer
            self._count(requests=1, errors=1)
            req.future.finish(e)

    def _dispatch(self, reqs: List[_Request]) -> None:
        head = reqs[0]
        try:
            results = mm_infer_batch(
                [r.sample for r in reqs], self.model, self.tokenizer,
                modal=head.modal, choice=head.choice, **head.gen,
            )
        except Exception:
            # batch failed: retry each sample alone, so one poisoned request
            # cannot fail its batchmates
            for r in reqs:
                try:
                    res = mm_infer_batch(
                        [r.sample], self.model, self.tokenizer,
                        modal=r.modal, choice=r.choice, **r.gen,
                    )[0]
                except Exception as e:  # noqa: BLE001 — delivered to the caller
                    self._count(requests=1, errors=1)
                    r.future.set_exception(e)
                    continue
                self._count(requests=1, fallback_samples=1)
                r.future.set_result(res)
            return
        self._count(requests=len(reqs), batches=1, batched_samples=len(reqs))
        self._record_latency(reqs)
        for r, res in zip(reqs, results):
            r.future.set_result(res)


# --------------------------------------------------------------------------
# HTTP front end (stdlib)
# --------------------------------------------------------------------------

def _np_from_b64(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)), allow_pickle=False)


def np_to_b64(a: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _build_sample(body: Dict[str, Any], cfg) -> Tuple[Dict[str, Any], str, int]:
    """JSON request body → mm_infer_batch sample dict (+ modal, choice).

    Video input: ``video_b64`` (base64 .npy [T,H,W,3]) or ``video_path``
    (decoded on the host by ``mm_utils.process_video``, with an optional
    s / e window; it needs cv2 and PIL). Region prompts: ``masks_rle`` (a
    list of COCO RLE dicts) + ``ann_indices`` + ``frame_b64``. Seg:
    ``images_sam_b64`` + ``label_size``.
    """
    modal = body.get("modal", "video")
    choice = int(body.get("choice", 1))
    sample: Dict[str, Any] = {"instruct": body["instruct"]}
    if modal != "text":
        if "video_b64" in body:
            sample["video"] = _np_from_b64(body["video_b64"])
        elif "video_path" in body:
            from .mm_utils import process_video

            video, _dense, _h, _w, _raw = process_video(
                body["video_path"],
                s=body.get("s"),
                e=body.get("e"),
                num_frames=int(body.get("num_frames", cfg.budget.num_frames)),
                image_size=cfg.vision.image_size,
            )
            sample["video"] = video
        else:
            raise ValueError("video modal needs 'video_b64' or 'video_path'")
    if "masks_rle" in body:
        masks = [rle.ann_to_mask(m) for m in body["masks_rle"]]
        sample["masks"] = np.stack(masks).astype(np.float32)
        sample["ann_indices"] = body.get("ann_indices")
    if "frame_b64" in body:
        sample["frame"] = _np_from_b64(body["frame_b64"])
    if "images_sam_b64" in body:
        sample["images_sam"] = _np_from_b64(body["images_sam_b64"])
    if "label_size" in body:
        sample["label_size"] = tuple(body["label_size"])
    return sample, modal, choice


def _encode_result(res) -> Dict[str, Any]:
    """One result → the reply's JSON: each mask frame as COCO RLE of a host
    bool array (the port returns masks as numpy)."""
    text, out = res
    masks_rle = [
        [rle.encode(frame) for frame in np.asarray(obj)]
        for obj in out.get("pred_masks", [])
    ]
    return {
        "text": text,
        "tokens": (
            list(map(int, out["output"])) if out.get("output") is not None else None
        ),
        "pred_masks_rle": masks_rle,
    }


def serve_http(
    scheduler: BatchingScheduler,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout_s: float = 600.0,
):
    """Start a threaded HTTP server over the scheduler; returns the server
    (the caller runs ``server.serve_forever()`` and later ``shutdown()``).
    Endpoints:

    - ``POST /v1/generate``: JSON body (see ``_build_sample``); replies
      ``{"text", "tokens", "pred_masks_rle"}`` (masks as per-frame COCO RLE),
      or with ``"stream": true`` server-sent events ``{"delta": ...}``
      ending in ``{"done": true}``; 400 on a malformed body.
    - ``GET /v1/stats``: scheduler counters.

    Handler threads block on the request future; batching happens in the
    scheduler's worker, so N concurrent HTTP clients become device batches.
    The handlers reach the scheduler through the server (``server.scheduler``),
    not through a closure: a class is freed only by the cycle collector, so a
    closure would keep the model alive after the server is dropped.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _event(self, obj: Dict[str, Any]) -> None:
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/v1/stats":
                self._send(200, self.server.scheduler.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {"error": "not found"})
                return
            scheduler = self.server.scheduler
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n))
                sample, modal, choice = _build_sample(body, scheduler.model.cfg)
                gen = {
                    k: body[k]
                    for k in ("max_new_tokens", "do_sample", "temperature", "top_p",
                              "seed", "stop_strings")
                    if k in body
                }
                if body.get("stream"):
                    if "chunk" in body:
                        gen["chunk"] = int(body["chunk"])
                    self._stream(scheduler.submit_stream(
                        sample, modal=modal, choice=choice, **gen))
                    return
                fut = scheduler.submit(sample, modal=modal, choice=choice, **gen)
                res = fut.result(timeout=request_timeout_s)
                self._send(200, _encode_result(res))
            except Exception as e:  # noqa: BLE001 — surfaced to the client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def _stream(self, sfut: StreamFuture) -> None:
            """Server-sent events of the text deltas; the response is
            close-delimited (no Content-Length)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for delta in sfut:
                    self._event({"delta": delta})
                self._event({"done": True})
            except (BrokenPipeError, ConnectionResetError):
                sfut.cancel()  # the client went away: stop the decode
            except Exception as e:  # noqa: BLE001 — a producer error mid-stream
                try:
                    self._event({"error": f"{type(e).__name__}: {e}"})
                except OSError:
                    sfut.cancel()

    server = ThreadingHTTPServer((host, port), Handler)
    server.scheduler = scheduler
    return server
