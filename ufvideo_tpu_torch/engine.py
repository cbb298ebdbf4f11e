"""Slot-based continuous batching engine: in-flight request admission (the
port of ``ufvideo_tpu/engine.py``).

Beyond the admission-batched scheduler (``serve.py``), the engine keeps ONE
persistent decode batch of ``max_slots`` sequences alive and lets requests
join it between decode chunks: a request arriving mid-decode is
vision-encoded, spliced and prefilled into a scratch cache, copied into a
free slot of the persistent KV cache, and decodes alongside the requests
already in flight, with no waiting for the current batch to finish. A decode
step reads every weight once whatever the batch, so each occupied slot is
extra throughput, and concurrent streams share each weight pass instead of
owning the card one after another.

Mechanics:
- Persistent state: a ``[L, max_slots, Hkv, S, D]`` KV cache with ``S =
  max_seq_len + max_new_cap (+ spec_k)`` positions rounded up to 128, plus
  host-side numpy ``cache_len`` / ``cur`` / ``done`` per slot (an idle slot
  is done). It is built on the first admission, so an idle engine holds no
  cache.
- Admission is pipelined and batched: admitter threads (``admitters``,
  default ``UFVIDEO_ENGINE_ADMITTERS`` or 2) run the expensive chain (frames
  to the card, vision encode, splice, prefill into a scratch cache) while
  the decode worker keeps stepping, and every request queued together rides
  one tower pass / splice and one prefill per 256-position length bucket, at
  most ``ADMIT_CHUNK`` requests a dispatch (a failed dispatch's requests retry
  alone, counted in ``admit_fallback_requests``). The worker only copies a
  prepared row into its slot between chunks (``_copy_slot`` /
  ``speculative.spec_slot_admit``). Slots are claimed before preparation,
  so prepared scratch caches never outnumber the free slots.
- Exactness: every admission stage and the decode step are row-independent,
  so a slot's tokens are those the request gives alone (``mm_infer``'s), up
  to the floating-point order of products whose row count differs. Each
  request's first token is taken from a one-row product, as ``mm_infer``
  takes it (the JAX engine samples a prefill's rows together).
- Stepping: one ``decode_chunk`` advances every active slot up to ``chunk``
  tokens; finished slots (eos, budget, stop string) retire between chunks
  and free their slot. With ``spec_k`` > 0 each step is instead one
  draft → verify pass of prompt-lookup speculation over every slot (1 to
  K + 1 tokens a slot); admission resets one row of the loop state and
  retirement ORs a host mask into it (``spec_set_done``).

On the card (the engine runs on its runtime's device, ``rt.device``, and has
no CPU fallback):
- each admitter thread launches on a CUDA stream of its own; the worker on
  the default stream. The quantised products keep their split-K partials per
  device and stream, and grad mode is per thread: every engine thread runs
  under ``torch.no_grad``;
- every hand-over between streams is ordered by an event, and every tensor
  used on a stream other than the one that allocated it is marked with
  ``record_stream``: a scratch cache (admitter → worker), frames staged on a
  client thread (staging stream → admitter) and inputs already on the card
  (the caller's stream → admitter);
- a client thread may stage a request's frames on the card
  (``UFVIDEO_ENGINE_PRESTAGE``, default on; ``0`` leaves the transfer to the
  admitter), at most ``max_slots`` payloads at once, counted under a lock;
  float32 frames are cast to bf16 on the host first when the model computes
  in bf16 (the tower's own cast: half the bytes to move).

Counters and spans (``stats()``, so ``GET /v1/stats``; always on): each
admission stage's device seconds, ``admit_<stage>_device_s`` and their sum
``admit_device_s``, from a pair of timing events on the admitter's stream
read without blocking (on the CPU, where each operation runs as it is
issued, the stage's host seconds); ``ready_wait_s``, prepared requests
waiting in ``_ready`` for the worker; a decode step's host seconds split
into ``launch_s`` (Python issuing work), ``wait_s`` (its host syncs) and
``emit_s`` (the text deltas and retirements), with ``launch_cpu_s``, the
worker's thread CPU seconds inside ``launch``; ``decode_rows`` (tokens the
decode steps made, row by row) and ``kv_live_pos_steps`` /
``kv_reserved_pos_steps`` (live slots' cache positions against the whole
cache, summed over steps; plain mode). While a ``torch.profiler`` session
runs, the same boundaries are spans (``utils.tracing``): ``request`` with
its ``queue``, ``slot_wait``, ``ready_wait``, ``install`` and ``retire``;
``admit`` with ``admit.transfer`` / ``.encode`` / ``.splice`` /
``.prefill``; ``step`` with its ``launch``, ``wait`` and ``emit`` phases. A
request's id is its ``request`` span's.

Not carried over from the JAX engine: ``_pow2pad``, which padded each
admission dispatch to a power-of-two batch to bound compile variants. The
port compiles nothing per shape, and a padding row would cost a whole
32-frame encode and a prefill.

Scope: greedy QA generation. Sampling requests need per-slot generators and
``[SEG]`` requests the full-pass hidden states: both go through the
``BatchingScheduler`` or ``mm_infer``.
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .api import (
    UFVideoRuntime,
    _assemble_input_ids,
    _encode_video_input,
    _frames,
    _on_device,
    _video_pixels,
)
from .constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN
from .mm_utils import TextDeltaStreamer
from .models.generate import _sampler, decode_chunk, prefill_cache
from .models.qwen2 import copy_cache_row as _copy_slot  # the scratch row into its slot
from .models.qwen2 import make_kv_cache
from .models.speculative import SpecState, _spec_body, spec_set_done, spec_slot_admit
from .serve import ServeFuture, StreamFuture
from .splicing import plan_lookup_ids
from .utils import tracing

__all__ = ["StreamingEngine"]

# most requests one admission dispatch carries: bounds the chain's transients
# (frames, tower activations, scratch caches); an admission takes at most
# as many queued requests as there are free slots
ADMIT_CHUNK = 4

_MODAL_TOKEN = {"image": DEFAULT_IMAGE_TOKEN, "video": DEFAULT_VIDEO_TOKEN, "text": ""}

ADMIT_STAGES = ("transfer", "encode", "splice", "prefill")


@dataclass
class _EngineRequest:
    sample: Dict[str, Any]
    modal: str
    choice: int
    gen: Dict[str, Any]
    future: Any  # StreamFuture (stream) or ServeFuture (collected)
    stream: bool
    t_enqueue: float = field(default_factory=time.perf_counter)
    # events on the streams that made the sample's tensors on the card
    events: List[Any] = field(default_factory=list)
    prestaged: bool = False  # holds one of the staging budget's payloads
    # the request's id, its ``request`` span's; its submission on the spans'
    # clock; when it was put in ``_ready`` (host clock, and spans' clock)
    rid: int = field(default_factory=tracing.RECORDER.new_id)
    t_ns: int = field(default_factory=time.time_ns)
    t_ready: float = 0.0
    ready_ns: int = 0


class _SlotState:
    """Host bookkeeping for one occupied slot."""

    def __init__(self, req: _EngineRequest, tokenizer):
        self.req = req
        # text deltas held back over a split character and a stop string's
        # reach (mm_utils.TextDeltaStreamer)
        self.streamer = TextDeltaStreamer(tokenizer, req.gen.get("stop_strings") or [])
        self.n_tokens = 0  # tokens consumed toward max_new
        self.max_new = int(req.gen.get("max_new_tokens", 1024))
        self.finished = False


@dataclass
class _Prepared:
    """A request after the admission chain, awaiting only its slot copy on
    the decode worker."""

    req: _EngineRequest
    scratch: Dict[str, torch.Tensor]  # prefilled scratch KV cache (maybe several rows)
    src: int  # this request's row in ``scratch``
    t0: int  # first generated token (from the prefill)
    real_len: int  # unpadded prompt length
    lookup_ids: Optional[np.ndarray]  # spec mode: [max_seq_len] prompt-lookup row
    ready: Any  # CUDA event after the prefill on the admitter's stream (None on the CPU)


class _Stages:
    """The stages of one admission dispatch, one after another on the
    admitter's thread and stream. Each stage ends at ``end``: on the card a
    timing event recorded there closes its device interval, read later
    without blocking (``StreamingEngine._read_stage_events``); on the CPU its
    host interval is its device time. While spans are recorded the dispatch
    is an ``admit`` span and each stage an ``admit.<stage>`` child."""

    def __init__(self, engine: "StreamingEngine", rids: List[int]):
        self.engine = engine
        self.rids = rids
        self.t = time.perf_counter()
        self.event = engine._timing_event()
        self.rec = tracing.on()
        if self.rec:
            self.id = tracing.RECORDER.new_id()
            self.ns = self.ns0 = time.time_ns()

    def end(self, stage: str, rids: Optional[List[int]] = None) -> None:
        eng = self.engine
        t = time.perf_counter()
        if eng._cuda:
            event = eng._timing_event()
            with eng._stage_events_lock:
                eng._stage_events.append((stage, self.event, event))
            self.event = event
        else:
            eng._add_stage(stage, t - self.t)
        self.t = t
        if self.rec:
            ns = time.time_ns()
            tracing.RECORDER.add(f"admit.{stage}", self.ns, ns, parent=self.id,
                                 requests=rids or self.rids)
            self.ns = ns

    def close(self) -> None:
        if self.rec:
            tracing.RECORDER.add("admit", self.ns0, self.ns, requests=self.rids,
                                 span_id=self.id)


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.") if torch.is_tensor(x) else x.dtype.name


class StreamingEngine:
    """Continuous-batching QA engine with the scheduler's surface
    (``submit`` / ``submit_stream`` / ``stats`` / ``close``), so
    ``serve.serve_http`` can front either."""

    def __init__(
        self,
        model: UFVideoRuntime,
        tokenizer,
        max_slots: int = 8,
        chunk: int = 8,
        max_new_cap: int = 512,
        max_queue: int = 256,
        spec_k: int = 0,
        admitters: int = 0,
    ) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.max_slots = int(max_slots)
        self.chunk = int(chunk)
        self.max_new_cap = int(max_new_cap)
        self.n_admitters = max(
            int(admitters) or int(os.environ.get("UFVIDEO_ENGINE_ADMITTERS", "2") or 2), 1)
        self._prestage_dev = os.environ.get("UFVIDEO_ENGINE_PRESTAGE", "1") != "0"
        self.spec_k = int(spec_k)
        cfg = model.cfg
        self.cache_positions = -(
            -(cfg.budget.max_seq_len + self.max_new_cap + self.spec_k) // 128) * 128
        self._device = model.device
        self._cuda = self._device.type == "cuda"
        self._llm = model.model.llm
        self._queue: "queue_mod.Queue[_EngineRequest]" = queue_mod.Queue(maxsize=int(max_queue))
        self._closing = False
        self._intake_lock = threading.Lock()
        self.stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "completed": 0, "errors": 0, "chunks": 0,
            "admissions": 0, "spec_drafted": 0, "spec_accepted": 0,
            # admission pipeline: dispatch chains and the requests they
            # carried, requests retried alone after their dispatch failed,
            # prefill dispatches (one a length bucket), decode steps; host
            # seconds of the admitters' chains (ending at the first token's
            # readback), of slot copies and of decode steps
            "admit_batches": 0, "admit_batched_requests": 0, "admit_fallback_requests": 0,
            "prefills": 0, "decode_steps": 0, "prep_s": 0.0, "install_s": 0.0, "step_s": 0.0,
            # the layers' split (module docstring): admission stages on the
            # device, the wait for the worker, a decode step's phases, the
            # batch's and the cache's use
            **{f"admit_{st}_device_s": 0.0 for st in ADMIT_STAGES}, "admit_device_s": 0.0,
            "ready_wait_s": 0.0, "launch_s": 0.0, "wait_s": 0.0, "emit_s": 0.0,
            "launch_cpu_s": 0.0, "decode_rows": 0, "kv_live_pos_steps": 0,
            "kv_reserved_pos_steps": 0,
        }
        # (stage, start event, end event) of admission stages on the card
        # whose end has not been seen yet
        self._stage_events: List[tuple] = []
        self._stage_events_lock = threading.Lock()
        # the per-slot spec counters as of the last step; a row adds into the
        # cumulative stats when it retires (admission resets the device row)
        self._slot_spec_counts = None
        self._lat: List[float] = []

        self._cache: Optional[Dict[str, torch.Tensor]] = None
        self._spec_state: Optional[SpecState] = None
        self._slots: List[Optional[_SlotState]] = [None] * self.max_slots
        self._cache_len = np.zeros(self.max_slots, np.int64)
        self._cur = np.zeros(self.max_slots, np.int64)
        self._done = np.ones(self.max_slots, bool)  # idle == done
        self._forced_done = np.zeros(self.max_slots, bool)  # spec mode

        # frames staged on the card by client threads: their own stream and
        # a budget of max_slots payloads, counted under a lock
        self._stage_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._prestage_lock = threading.Lock()
        self._prestaged = 0

        # prepared requests wait in ``_ready`` for the worker; ``_reserved``
        # holds the slots claimed for them. Claims, occupation and release
        # of a slot all happen under ``_admit_lock``.
        self._ready: "queue_mod.Queue" = queue_mod.Queue()
        self._reserved: set = set()
        self._admit_lock = threading.Lock()

        self._worker = threading.Thread(target=self._run, name="ufvideo-engine", daemon=True)
        self._admitters = [
            threading.Thread(target=self._admit_loop, name=f"ufvideo-admit-{i}", daemon=True)
            for i in range(self.n_admitters)
        ]
        self._worker.start()
        for t in self._admitters:
            t.start()

    # ---------------- client surface ----------------

    def _check(self, sample: Dict[str, Any], gen: Dict[str, Any]) -> None:
        if gen.get("do_sample"):
            raise ValueError("engine mode is greedy-only; route sampling requests "
                             "through the BatchingScheduler")
        if sample.get("images_sam") is not None:
            raise ValueError("engine mode is QA-only ([SEG]/mask decoding needs the "
                             "full-pass mm_infer path)")
        if int(gen.get("max_new_tokens", 1024)) > self.max_new_cap:
            raise ValueError(f"max_new_tokens exceeds the engine cap {self.max_new_cap}")

    def _record(self, stream) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def _prestage(self, req: _EngineRequest) -> None:
        """Client-thread staging: order the admitter after the caller's
        stream when the sample holds tensors on the card; cast float32
        frames to bf16 on the host when the model computes in bf16; while
        fewer than ``max_slots`` staged payloads are in flight, copy the
        frames to the card on the staging stream."""
        s = req.sample
        if self._cuda and any(torch.is_tensor(v) and v.is_cuda for v in s.values()):
            req.events.append(self._record(torch.cuda.current_stream(self._device)))
        vid = s.get("video")
        if vid is None or (torch.is_tensor(vid) and vid.is_cuda):
            return
        host = vid if torch.is_tensor(vid) else torch.from_numpy(np.ascontiguousarray(vid))
        if host.dtype == torch.float32 and self.model.cfg.compute_dtype == torch.bfloat16:
            s["video"] = host = host.to(torch.bfloat16)
        if not (self._cuda and self._prestage_dev):
            return
        with self._prestage_lock:
            if self._prestaged >= self.max_slots:
                return
            self._prestaged += 1
        req.prestaged = True
        with torch.cuda.stream(self._stage_stream):
            s["video"] = host.to(self._device)
            req.events.append(self._record(self._stage_stream))

    def _release(self, req: _EngineRequest) -> None:
        """Drop the request's frames (the encode consumed them) and, if they
        were staged, their place in the staging budget."""
        req.sample.pop("video", None)
        if req.prestaged:
            req.prestaged = False
            with self._prestage_lock:
                self._prestaged -= 1

    def _submit(self, sample, modal, choice, gen, stream) -> Any:
        self._check(sample, gen)
        fut = StreamFuture() if stream else ServeFuture()
        req = _EngineRequest(dict(sample), modal, int(choice), dict(gen), fut, stream)
        if self._closing:
            raise RuntimeError("engine is closed")
        try:
            self._prestage(req)
        except BaseException:
            self._release(req)  # its place in the staging budget
            raise
        with self._intake_lock:  # close() cannot slip between the check and the put
            if self._closing:
                self._release(req)
                raise RuntimeError("engine is closed")
            try:
                self._queue.put_nowait(req)
            except queue_mod.Full:
                self._release(req)
                raise RuntimeError(f"queue full ({self._queue.maxsize} pending)") from None
        return fut

    def submit(self, sample, modal="video", choice=1, **gen) -> ServeFuture:
        """Non-streaming request: resolves to ``(text, out_dict)`` like the
        scheduler (``pred_masks`` always empty: a QA engine). Frames as
        numpy arrays or as tensors on any device."""
        return self._submit(sample, modal, choice, gen, stream=False)

    def submit_stream(self, sample, modal="video", choice=1, **gen) -> StreamFuture:
        return self._submit(sample, modal, choice, gen, stream=True)

    def stats(self) -> Dict[str, Any]:
        self._read_stage_events()
        with self.stats_lock:
            s = dict(self._stats)
            lat = sorted(self._lat[-512:])
        for key in [k for k in s if k.endswith("_s")]:
            s[key] = round(s[key], 3)
        s["active_slots"] = sum(sl is not None for sl in self._slots)
        # pending: queued, plus prepared and awaiting their slot copy
        s["pending"] = self._queue.qsize() + self._ready.qsize()
        drafted, accepted = s.pop("spec_drafted"), s.pop("spec_accepted")
        if self.spec_k:
            counts = self._slot_spec_counts
            if counts is not None:
                drafted += int(counts[0].sum())
                accepted += int(counts[1].sum())
            s["spec"] = {"drafted": drafted, "accepted": accepted}
        if lat:
            s["latency_s"] = {
                "p50": round(lat[len(lat) // 2], 4),
                "p95": round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 4),
            }
        return s

    def close(self, timeout: float = 120.0) -> None:
        """Stop intake, finish every queued and running request, join the
        threads."""
        with self._intake_lock:
            self._closing = True
        t0 = time.perf_counter()
        for t in self._admitters:
            t.join(max(timeout - (time.perf_counter() - t0), 0.1))
        self._worker.join(max(timeout - (time.perf_counter() - t0), 0.1))

    def __enter__(self) -> "StreamingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------- admitters (the preparation pipeline) ----------------

    def _free_unreserved(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None and i not in self._reserved]

    def _unreserve(self, slot: int) -> None:
        with self._admit_lock:
            self._reserved.discard(slot)

    @staticmethod
    def _end_request(req: _EngineRequest) -> None:
        if tracing.on():
            tracing.RECORDER.add("request", req.t_ns, time.time_ns(), requests=(req.rid,),
                                 span_id=req.rid)

    def _deliver_error(self, req: _EngineRequest, exc: BaseException) -> None:
        self._end_request(req)
        with self.stats_lock:
            self._stats["errors"] += 1
        if req.stream:
            req.future.finish(exc)
        else:
            req.future.set_exception(exc)

    def _admit_loop(self) -> None:
        """Admitter thread: the chain from frames to first token for
        everything queued together, on a CUDA stream of this thread's own.
        Decode keeps stepping meanwhile; the two meet at ``_install``."""
        stream = torch.cuda.Stream(self._device) if self._cuda else None
        on_stream = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with torch.no_grad(), on_stream:
            while True:
                try:
                    req = self._queue.get(timeout=0.05)
                except queue_mod.Empty:
                    # every put happened before closing was set (intake
                    # lock), so an empty queue now is empty for good
                    if self._closing and self._queue.empty():
                        return
                    continue
                taken_ns = time.time_ns() if tracing.on() else 0
                # wait for a free slot, so prepared scratch caches stay
                # within the slot budget; claim the slots and take batchmates
                # atomically, so two admitters never book one slot
                while True:
                    with self._admit_lock:
                        free = self._free_unreserved()
                        if free:
                            reqs = [req]
                            while len(reqs) < len(free):
                                try:
                                    reqs.append(self._queue.get_nowait())
                                except queue_mod.Empty:
                                    break
                            slots = free[:len(reqs)]
                            self._reserved.update(slots)
                            break
                    time.sleep(0.002)
                if tracing.on():
                    claimed_ns = time.time_ns()
                    for r in reqs:  # batchmates leave the queue as the slots are claimed
                        t = taken_ns if r is req and taken_ns else claimed_ns
                        tracing.RECORDER.add("queue", r.t_ns, t, parent=r.rid, requests=(r.rid,))
                        tracing.RECORDER.add("slot_wait", t, claimed_ns, parent=r.rid,
                                             requests=(r.rid,))
                with self.stats_lock:
                    self._stats["requests"] += len(reqs)
                try:
                    results = self._prepare(reqs)
                except BaseException as e:  # noqa: BLE001 — the admitter must live
                    results = [e] * len(reqs)
                for r, slot, res in zip(reqs, slots, results):
                    if isinstance(res, BaseException):
                        self._deliver_error(r, res)
                        self._unreserve(slot)
                    else:
                        r.t_ready = time.perf_counter()
                        r.ready_ns = time.time_ns() if tracing.on() else 0
                        self._ready.put((slot, res))

    def _enter_inputs(self, req: _EngineRequest) -> None:
        """Order the current stream after the streams that made the request's
        tensors on the card, and mark those tensors as used on it."""
        if not self._cuda:
            return
        cur = torch.cuda.current_stream(self._device)
        for ev in req.events:
            cur.wait_event(ev)
        for v in req.sample.values():
            if torch.is_tensor(v) and v.is_cuda:
                v.record_stream(cur)

    def _ready_event(self):
        return self._record(torch.cuda.current_stream(self._device)) if self._cuda else None

    def _prepare(self, reqs: List[_EngineRequest]) -> List[Any]:
        """The admission chain for a batch of requests: same-shaped plain
        video requests share one encode / splice / prefill chain (each stage
        is row-independent); text, image and region requests, and the
        members of a group that failed, prepare alone. Returns one
        ``_Prepared`` or exception per request."""
        model = self.model
        results: List[Any] = [None] * len(reqs)
        pend = []
        for i, req in enumerate(reqs):
            try:
                self._enter_inputs(req)
                ids = _assemble_input_ids(req.sample["instruct"], req.choice,
                                          _MODAL_TOKEN[req.modal], self.tokenizer)
                if model.ids.seg in ids:
                    raise ValueError("engine mode is QA-only ([SEG] in prompt)")
                pend.append((i, ids))
            except Exception as e:  # noqa: BLE001 — delivered to the caller
                results[i] = e
        groups: Dict[tuple, List[tuple]] = {}
        solo: List[tuple] = []
        for i, ids in pend:
            s = reqs[i].sample
            vid = s.get("video")
            if reqs[i].modal == "video" and vid is not None and s.get("frame") is None \
                    and s.get("masks") is None:
                arr = _frames(vid)  # a tensor stays where it lies
                groups.setdefault((tuple(arr.shape), _dtype_name(arr)), []).append((i, ids, arr))
            else:
                solo.append((i, ids))
        for members in groups.values():
            self._prepare_video_group(reqs, members, results)
            solo.extend((i, ids) for i, ids, _ in members if results[i] is None)
        for i, ids in solo:
            try:
                results[i] = self._prepare_one(reqs[i], ids)
            except Exception as e:  # noqa: BLE001 — delivered to the caller
                results[i] = e
        for req in reqs:
            self._release(req)
        return results

    def _timing_event(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def _add_stage(self, stage: str, seconds: float) -> None:
        with self.stats_lock:
            self._stats[f"admit_{stage}_device_s"] += seconds
            self._stats["admit_device_s"] += seconds

    def _read_stage_events(self) -> None:
        """Add the device seconds of every admission stage whose end event
        has completed to its counter; ``query`` never blocks."""
        if not self._cuda:
            return
        ended, pending = [], []
        with self._stage_events_lock:
            for e in self._stage_events:
                (ended if e[2].query() else pending).append(e)
            self._stage_events = pending
        for stage, start, end in ended:
            self._add_stage(stage, start.elapsed_time(end) / 1e3)

    def _prepare_video_group(self, reqs, members, results) -> None:
        """Same-shaped video requests in sub-batches of at most
        ``ADMIT_CHUNK``: each shares one transfer, one vision encode, one
        splice and one prefill per 256-position length bucket. A failed
        sub-batch leaves its members' results None: ``_prepare`` retries them
        alone, and ``admit_fallback_requests`` counts them."""
        for start in range(0, len(members), ADMIT_CHUNK):
            sub = members[start:start + ADMIT_CHUNK]
            try:
                self._prepare_video_subgroup(reqs, sub, results)
            except Exception:  # noqa: BLE001 — the members retry alone
                with self.stats_lock:
                    self._stats["admit_fallback_requests"] += sum(
                        results[i] is None for i, _, _ in sub)

    def _prefill(self, embeds: torch.Tensor, lens) -> tuple:
        """Prefill rows of spliced embeddings into a scratch cache as long as
        their bucket → (scratch, first tokens on the host). Each row's first
        token comes from its own one-row product, as ``mm_infer`` computes
        it: on the card the quantised ``lm_head`` at several rows takes the
        2-32-row kernel, which sums in another order, so a batchmate could
        move a near tie."""
        cfg = self.model.cfg
        llm = self._llm
        scratch = make_kv_cache(llm.cfg, embeds.shape[0], -(-embeds.shape[1] // 128) * 128,
                                dtype=llm.dtype, device=self._device, quant=bool(cfg.quant_kv))
        scratch, last = prefill_cache(
            llm, embeds, torch.as_tensor(lens, device=self._device, dtype=torch.int32), scratch)
        greedy = _sampler(llm, cfg.llm.vocab_size, None, False, 1.0, 1.0)
        t0 = torch.cat([greedy(last[i:i + 1]) for i in range(embeds.shape[0])])
        with self.stats_lock:
            self._stats["prefills"] += 1
        return scratch, t0.tolist()

    def _encode(self, px: torch.Tensor) -> torch.Tensor:
        """[G, T, H, W, 3] frames → [G, V, d] video tokens: the tower over
        all G·T frames at once, the projector one video at a time, as
        ``mm_infer`` runs it (its 3-D convolutions choose their algorithm by
        batch on the card, so a batch of videos would round otherwise than
        one; the tower's rows do not depend on their batchmates)."""
        model = self.model.model
        g, t = px.shape[:2]
        px = _video_pixels(self.model, px.reshape((g * t,) + tuple(px.shape[2:])), "video")
        tokens = model.vision(px)
        tokens = tokens.reshape((g, t) + tuple(tokens.shape[1:]))
        return torch.cat([model.projector(tokens[i:i + 1]) for i in range(g)])

    def _prepare_video_subgroup(self, reqs, members, results) -> None:
        model, cfg = self.model, self.model.cfg
        t_start = time.perf_counter()
        stages = _Stages(self, [reqs[i].rid for i, _, _ in members])
        vids = [arr for _, _, arr in members]
        if all(isinstance(v, np.ndarray) for v in vids):
            px = _on_device(np.stack(vids), self._device)  # one host → card copy
        else:
            px = torch.stack([_on_device(v, self._device) for v in vids])
        stages.end("transfer")
        feats = self._encode(px)  # [G, V, d]
        del px
        stages.end("encode")
        plan, embeds = model._splice_plan([ids for _, ids, _ in members], feats)
        del feats
        stages.end("splice")
        real_lens = [int(n) for n in plan.seq_lens]
        buckets: Dict[int, List[int]] = {}
        for j, rl in enumerate(real_lens):
            trim = min((rl + 255) // 256 * 256, cfg.budget.max_seq_len)
            buckets.setdefault(trim, []).append(j)
        lookup_rows = plan_lookup_ids(plan) if self.spec_k else None
        for trim, rows in buckets.items():
            scratch, t0 = self._prefill(
                embeds[torch.as_tensor(rows, device=self._device), :trim],
                [real_lens[j] for j in rows])
            stages.end("prefill", [reqs[members[j][0]].rid for j in rows])
            ready = self._ready_event()
            for rj, j in enumerate(rows):
                i = members[j][0]
                results[i] = _Prepared(reqs[i], scratch, rj, int(t0[rj]), real_lens[j],
                                       lookup_rows[j] if self.spec_k else None, ready)
        stages.close()
        with self.stats_lock:
            self._stats["admit_batches"] += 1
            self._stats["admit_batched_requests"] += len(members)
            self._stats["prep_s"] += time.perf_counter() - t_start

    def _prepare_one(self, req: _EngineRequest, input_ids) -> _Prepared:
        """The chain for one request (text, image and region requests, or a
        member of a failed group). Its tensors stay on their device. Its
        stages are encode (the frames' transfer inside), splice, prefill."""
        t_start = time.perf_counter()
        stages = _Stages(self, [req.rid])
        model = self.model
        s = req.sample
        video_feats = _encode_video_input(model, s.get("video"), req.modal)
        region_feats, region_counts = None, None
        if s.get("frame") is not None and s.get("masks") is not None:
            region_feats, region_counts = model.pack_and_encode_regions(
                s["frame"], s["masks"], s.get("ann_indices"))
        stages.end("encode")
        plan, embeds = model._splice_plan([input_ids], video_feats, region_feats,
                                          [region_counts or []])
        stages.end("splice")
        scratch, t0 = self._prefill(embeds, plan.seq_lens)
        stages.end("prefill")
        stages.close()
        lookup = plan_lookup_ids(plan)[0] if self.spec_k else None
        prep = _Prepared(req, scratch, 0, int(t0[0]), int(plan.seq_lens[0]), lookup,
                         self._ready_event())
        with self.stats_lock:
            self._stats["prep_s"] += time.perf_counter() - t_start
        return prep

    # ---------------- the decode worker ----------------

    def _install(self, slot: int, prep: _Prepared) -> None:
        """Copy a prepared request into its slot: the only admission work
        that touches the decode state, between chunks, on the worker's
        stream after the prefill's event."""
        t_start = time.perf_counter()
        start_ns = time.time_ns() if tracing.on() else 0
        req = prep.req
        if start_ns and req.ready_ns:
            tracing.RECORDER.add("ready_wait", req.ready_ns, start_ns, parent=req.rid,
                                 requests=(req.rid,))
        self._read_stage_events()
        cfg = self.model.cfg
        if self._cuda:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(prep.ready)
        if self.spec_k:
            if self._spec_state is None:
                self._spec_state = self._init_spec_state()
            s_off = cfg.budget.max_seq_len
            row = np.full((s_off + self.max_new_cap,), -1, np.int64)
            row[:s_off] = prep.lookup_ids
            spec_slot_admit(self._spec_state, slot, prep.scratch, prep.t0, prep.real_len,
                            torch.from_numpy(row), src=prep.src)
        else:
            if self._cache is None:
                self._cache = make_kv_cache(self._llm.cfg, self.max_slots, self.cache_positions,
                                            dtype=self._llm.dtype, device=self._device,
                                            quant=bool(cfg.quant_kv))
            _copy_slot(self._cache, prep.scratch, slot, prep.src)
            self._cache_len[slot] = prep.real_len
            self._cur[slot] = prep.t0
        if self._cuda:
            # the scratch was allocated on the admitter's stream: keep its
            # blocks from the next admission until this copy has run
            for t in prep.scratch.values():
                t.record_stream(cur)
        st = _SlotState(prep.req, self.tokenizer)
        with self._admit_lock:
            self._slots[slot] = st  # occupy before the reservation goes
            self._reserved.discard(slot)
        self._done[slot] = False
        self._forced_done[slot] = False
        with self.stats_lock:
            self._stats["admissions"] += 1
            self._stats["install_s"] += time.perf_counter() - t_start
            self._stats["ready_wait_s"] += t_start - req.t_ready
        if start_ns:
            tracing.RECORDER.add("install", start_ns, time.time_ns(), parent=req.rid,
                                 requests=(req.rid,))
        self._emit(slot, [prep.t0])

    def _init_spec_state(self) -> SpecState:
        """A loop state with every slot idle (done)."""
        b, cap, dev = self.max_slots, self.max_new_cap, self._device
        s_off = self.model.cfg.budget.max_seq_len
        zeros = lambda: torch.zeros((b,), dtype=torch.int64, device=dev)
        return SpecState(
            it=0,
            tokens=torch.zeros((b, cap), dtype=torch.int64, device=dev),
            hiddens=torch.zeros((b, cap, self._llm.cfg.hidden_size), dtype=self._llm.dtype,
                                device=dev),
            cache=make_kv_cache(self._llm.cfg, b, self.cache_positions, dtype=self._llm.dtype,
                                device=dev, quant=bool(self.model.cfg.quant_kv)),
            cache_len=zeros(), cur=zeros(),
            done=torch.ones((b,), dtype=torch.bool, device=dev),
            gen_lens=zeros(),
            hist=torch.full((b, s_off + cap), -1, dtype=torch.int64, device=dev),
            n_drafted=zeros(), n_accepted=zeros())

    def _emit(self, slot: int, new_ids: List[int]) -> None:
        """Append tokens to a slot, stream the safe text delta, apply the
        host's stop rules (eos stops on the card; stop strings and the
        budget here)."""
        st = self._slots[slot]
        take = min(len(new_ids), st.max_new - st.n_tokens)
        taken = new_ids[:take]
        st.n_tokens += take
        eos_hit = self.model.ids.eos in taken
        delta, stopped = st.streamer.push(taken)
        if st.req.stream:
            if st.req.future.cancelled:
                self._retire(slot)
                return
            if delta:
                st.req.future.push(delta)
        if stopped or eos_hit or st.n_tokens >= st.max_new:
            self._retire(slot)

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        st.finished = True
        start_ns = time.time_ns() if tracing.on() else 0
        try:
            final = st.streamer.finish()  # the held tail
            if st.req.stream:
                if final and not st.req.future.cancelled:
                    st.req.future.push(final)
                st.req.future.finish()
            else:
                st.req.future.set_result(
                    (st.streamer.text().strip(), {"output": st.streamer.ids, "pred_masks": []}))
        finally:
            with self.stats_lock:
                self._stats["completed"] += 1
                if self._slot_spec_counts is not None:
                    for key, counts in zip(("spec_drafted", "spec_accepted"),
                                           self._slot_spec_counts):
                        self._stats[key] += int(counts[slot])
                        counts[slot] = 0
                self._lat.append(time.perf_counter() - st.req.t_enqueue)
                if len(self._lat) > 2048:
                    del self._lat[:1024]
            with self._admit_lock:
                self._slots[slot] = None
            self._done[slot] = True
            # plain mode: a done row still writes its k/v at cache_len each
            # step; position 0 of a free slot is always inside the cache
            self._cache_len[slot] = 0
            # spec mode: the loop state's done flag follows before the next
            # step, or the row keeps verifying
            self._forced_done[slot] = True
            if start_ns:
                rid = st.req.rid
                tracing.RECORDER.add("retire", start_ns, time.time_ns(), parent=rid,
                                     requests=(rid,))
            self._end_request(st.req)

    def _step(self) -> None:
        """One decode dispatch over every slot: up to ``chunk`` steps of
        ``decode_chunk``, or one draft → verify iteration in spec mode. Its
        host time splits into ``launch``, ``wait`` (each host sync) and
        ``emit`` (``tracing.Split``)."""
        t_start = time.perf_counter()
        rids = [sl.req.rid for sl in self._slots if sl is not None] if tracing.on() else ()
        with tracing.Split("step", "launch", rids) as split:
            counts = self._spec_chunk(split) if self.spec_k else self._plain_chunk(split)
        with self.stats_lock:
            self._stats["chunks"] += 1
            for key, value in counts.items():
                self._stats[key] += value
            for kind in ("launch", "wait", "emit"):
                self._stats[f"{kind}_s"] += split.seconds(kind)
            self._stats["launch_cpu_s"] += split.cpu_seconds("launch")
            self._stats["step_s"] += time.perf_counter() - t_start

    def _spec_chunk(self, split: tracing.Split) -> Dict[str, int]:
        cfg = self.model.cfg
        if self._forced_done.any():
            spec_set_done(self._spec_state, self._forced_done)
            self._forced_done[:] = False
        st = self._spec_state = _spec_body(
            self._llm, self._spec_state, k=self.spec_k, stop_ids=(self.model.ids.eos,),
            vocab_size=cfg.llm.vocab_size, max_new_tokens=self.max_new_cap,
            prompt_len=cfg.budget.max_seq_len)
        with tracing.wait():
            tokens = st.tokens.cpu().numpy()
            gen_lens = st.gen_lens.cpu().numpy()
            self._done = st.done.cpu().numpy().copy()
            self._slot_spec_counts = (st.n_drafted.cpu().numpy().copy(),
                                      st.n_accepted.cpu().numpy().copy())
        split.switch("emit")
        for slot, sl in enumerate(self._slots):
            if sl is None:
                continue
            new, prev = int(gen_lens[slot]), sl.n_tokens
            if new > prev:
                self._emit(slot, tokens[slot, prev:new].tolist())
            if self._slots[slot] is not None and self._done[slot]:
                self._retire(slot)
        return {}

    def _plain_chunk(self, split: tracing.Split) -> Dict[str, int]:
        cfg = self.model.cfg
        live = ~self._done
        # a step writes each row's k/v at its cache_len: the chunk ends
        # before the fullest live row runs off the cache
        chunk = self.chunk
        if live.any():
            chunk = min(chunk, int(self.cache_positions - self._cache_len[live].max()))
        as_dev = lambda a: torch.as_tensor(a, device=self._device)
        tokens, n, _hiddens, self._cache, cache_len, cur, done = decode_chunk(
            self._llm, self._cache, as_dev(self._cache_len), as_dev(self._cur),
            as_dev(self._done), chunk=chunk, stop_ids=(self.model.ids.eos,),
            vocab_size=cfg.llm.vocab_size)
        held = self._cache_len
        with tracing.wait():
            tokens = tokens.cpu().numpy()
            n = n.cpu().numpy()
            self._cache_len = cache_len.cpu().numpy().copy()
            self._cur = cur.cpu().numpy().copy()
            self._done = done.cpu().numpy().copy()
        steps = int(n.max(initial=0))
        counts = {"decode_steps": steps, "decode_rows": int(n.sum()),
                  # a row live for n steps holds held + 1 .. held + n positions
                  "kv_live_pos_steps": int((n * held + n * (n + 1) // 2).sum()),
                  "kv_reserved_pos_steps": self.max_slots * self.cache_positions * steps}
        split.switch("emit")
        for slot, sl in enumerate(self._slots):
            if sl is None:
                continue
            k = int(n[slot])
            if k:
                self._emit(slot, tokens[slot, :k].tolist())
            if self._slots[slot] is not None and self._done[slot]:
                # eos landed in the chunk but the slot is still held (no
                # budget or stop string hit): retire on the card's verdict
                self._retire(slot)
        return counts

    def _run(self) -> None:
        with torch.no_grad():
            while True:
                # copy prepared admissions into their slots between chunks
                installed = False
                while True:
                    try:
                        slot, prep = self._ready.get_nowait()
                    except queue_mod.Empty:
                        break
                    try:
                        self._install(slot, prep)
                        installed = True
                    except Exception as e:  # noqa: BLE001 — delivered to the caller
                        self._deliver_error(prep.req, e)
                        self._unreserve(slot)
                if not any(s is not None for s in self._slots):
                    # drain on close: leave once the admitters have emptied
                    # the queue and exited, with nothing left to copy in
                    if self._closing and not any(t.is_alive() for t in self._admitters) \
                            and self._ready.empty():
                        return
                    if not installed:
                        time.sleep(0.002)
                    continue
                try:
                    self._step()
                except Exception as e:  # noqa: BLE001 — delivered to the callers
                    # a failed step must not kill the worker (every active and
                    # queued request would hang): fail the slots in flight,
                    # drop the decode state (rebuilt on the next admission)
                    self._fail_active(e)

    def _fail_active(self, exc: BaseException) -> None:
        with self.stats_lock:
            self._stats["errors"] += sum(s is not None for s in self._slots)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            self._end_request(st.req)
            try:
                if st.req.stream:
                    st.req.future.finish(exc)
                else:
                    st.req.future.set_exception(exc)
            finally:
                with self._admit_lock:
                    self._slots[slot] = None
        self._done[:] = True
        self._forced_done[:] = False
        self._cache_len[:] = 0
        self._cache = None
        self._spec_state = None
        self._slot_spec_counts = None
