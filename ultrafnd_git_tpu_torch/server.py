"""HTTP serving over the port's Predictor (counterpart of
`ultrafnd_git_tpu/server.py`), standard library only:

  POST /predict   {"records": [...]}                  -> {"predictions": [...]}
  POST /explain   {"records": [...], "method": "grad",
                   "top_k": 8}                        -> {"predictions": [...]}
  GET  /healthz                                       -> {"status": "ok", ...}
  GET  /stats                                         -> batching counters

Records use `data_complete.json` semantics (title/ocr/comments/...).

* ThreadingHTTPServer accepts concurrent connections; device work is
  serialised behind one lock (the Predictor's modules and featurize
  worker are one pipeline, and one pipeline bounds device memory).
* Concurrent /predict requests coalesce through a DynamicBatcher:
  requests arriving within a small window are featurized together
  outside the lock and scored as one `Predictor.predict_featurized` call
  under it. Scoring is row-independent (a new record attaches to the
  training corpus, never to other records of the batch), so coalescing
  is exact: predict(a + b) == predict(a) + predict(b) row for row, up to
  the bucket the rows are padded to. A switch-MoE tower is the exception,
  as in the JAX server: its expert capacity is shared by the rows of a
  dispatch, so where it drops a token a row depends on its neighbours.
* Errors return JSON {"error": ...} with 4xx/5xx: malformed input never
  takes the server down.
* /healthz reports the torch device the Predictor runs on and, on CUDA,
  the card's name.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from ultrafnd_git_tpu_torch.serving import Predictor

MAX_BODY_BYTES = 64 * 1024 * 1024  # one request can carry many records


class _BatchEntry:
    __slots__ = ("records", "event", "result", "error", "arrival")

    def __init__(self, records: List[dict]):
        self.records = records
        self.event = threading.Event()
        self.result: Optional[List[dict]] = None
        self.error: Optional[BaseException] = None
        self.arrival = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent predict() calls into one device dispatch.

    A featurize thread drains the queue: on arrival of the first
    waiting request it keeps collecting for up to `window_ms` (or until
    `max_batch` records), FEATURIZES the window (host CPU work, outside
    the device lock), and hands it to a scorer thread that runs ONE
    device dispatch (`Predictor.predict_featurized`) under the lock and
    fans the rows back out per caller. The two stages pipeline: window
    N+1 featurizes while window N's dispatch is in flight, so host
    featurizing does not serialise with the device. Exactness relies on
    row-independent scoring (see module docstring).

    `window_ms=0` still coalesces whatever is queued while the device
    is busy (natural batching), it just never waits for more.
    """

    def __init__(
        self,
        predictor: Predictor,
        lock: threading.Lock,
        max_batch: int = 4096,
        window_ms: float = 4.0,
        gap_ms: float = 3.0,
    ):
        import queue

        self.predictor = predictor
        self.lock = lock  # shared with /explain (one device pipeline)
        self.max_batch = int(max_batch)
        self.window_s = max(0.0, float(window_ms)) / 1e3
        # Arrival-gap early close: `window_ms` is the MAX wait, but when
        # arrivals go quiet for `gap_ms` the window closes at once: a
        # synchronised burst of clients (every caller blocked on the
        # previous dispatch reposts within a few ms of the fan-out) would
        # otherwise idle out the full window on every cycle. Exactness is
        # unaffected (same records, possibly split across more dispatches).
        self.gap_s = max(0.0, float(gap_ms)) / 1e3
        self.batches = 0  # dispatches actually issued (stats/tests)
        self.records = 0  # records scored through those dispatches
        self._cv = threading.Condition()
        self._queue: List[_BatchEntry] = []
        self._stop = False
        # depth-2 handoff: one window featurizing, one dispatching;
        # deeper pipelines only add latency before first byte
        self._scoreq: "queue.Queue" = queue.Queue(maxsize=2)
        self._featurizer = threading.Thread(
            target=self._featurize_loop, name="batcher-featurize",
            daemon=True,
        )
        self._scorer = threading.Thread(
            target=self._score_loop, name="batcher-score", daemon=True
        )
        self._featurizer.start()
        self._scorer.start()

    # ------------------------------------------------------------------
    def submit(self, records: List[dict]) -> List[dict]:
        """Blocking: enqueue, wait for the coalesced dispatch, return
        this request's rows (or re-raise its scoring error)."""
        if not records:
            return []
        entry = _BatchEntry(records)
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(entry)
            self._cv.notify_all()
        entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._featurizer.join(timeout=5.0)
        self._scorer.join(timeout=5.0)

    # ------------------------------------------------------------------
    def _take_batch(self) -> List[_BatchEntry]:
        """Wait for work, apply the window, drain up to max_batch rows."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait()
            if self._stop and not self._queue:
                return []
            # the window runs from the OLDEST queued entry's arrival,
            # not from when this worker woke up — requests that aged in
            # the queue during the previous dispatch go out immediately;
            # a quiet arrival gap (gap_s since the NEWEST entry) closes
            # it early (see __init__)
            deadline = self._queue[0].arrival + self.window_s
            while not self._stop:
                queued = sum(len(e.records) for e in self._queue)
                newest = max(e.arrival for e in self._queue)
                remaining = (
                    min(deadline, newest + self.gap_s) - time.monotonic()
                )
                if queued >= self.max_batch or remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch: List[_BatchEntry] = []
            total = 0
            while self._queue:
                # always take at least one entry, even if oversized —
                # the Predictor chunks internally anyway
                if batch and total + len(self._queue[0].records) > (
                    self.max_batch
                ):
                    break
                e = self._queue.pop(0)
                batch.append(e)
                total += len(e.records)
            return batch

    def _featurize_loop(self) -> None:
        """Stage 1: collect a window, featurize it OUTSIDE the device
        lock, hand (batch, flat, cache-or-error) to the scorer. While
        the scorer's dispatch is in flight this loop is already
        featurizing the next window."""
        while True:
            batch = self._take_batch()
            if not batch:
                self._scoreq.put(None)  # closed and drained
                return
            flat: List[dict] = []
            for e in batch:
                flat.extend(e.records)
            cache = err = None
            if len(flat) <= self.max_batch:
                try:
                    cache = self.predictor.featurize(flat, 0)
                except BaseException as exc:  # noqa: BLE001
                    err = exc
            # an oversized single entry (> max_batch) skips
            # prefeaturization: the scorer routes it through
            # predictor.predict, which chunks internally
            self._scoreq.put((batch, flat, cache, err))

    def _score_loop(self) -> None:
        """Stage 2: one device dispatch per featurized window under the
        lock; fan rows back out per caller."""
        while True:
            item = self._scoreq.get()
            if item is None:
                return
            batch, flat, cache, err = item
            try:
                if err is not None:
                    raise err
                with self.lock:
                    if cache is None:  # oversized entry: chunked path
                        preds = self.predictor.predict(flat)
                    else:
                        preds = self.predictor.predict_featurized(
                            cache, len(flat)
                        )
                with self._cv:
                    self.batches += 1
                    self.records += len(flat)
                off = 0
                for e in batch:
                    e.result = preds[off:off + len(e.records)]
                    off += len(e.records)
            except BaseException as exc:  # noqa: BLE001
                if len(batch) == 1:
                    batch[0].error = exc
                else:
                    # one malformed request must not 500 the innocent
                    # callers sharing its window — retry each entry
                    # alone so every caller gets ITS OWN outcome
                    for e in batch:
                        try:
                            with self.lock:
                                e.result = self.predictor.predict(
                                    e.records
                                )
                            with self._cv:
                                self.batches += 1
                                self.records += len(e.records)
                        except BaseException as solo:  # noqa: BLE001
                            e.error = solo
            finally:
                for e in batch:
                    e.event.set()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1: responses always carry Content-Length (see _reply), so
    # connections persist across requests. Under the stdlib's
    # thread-per-CONNECTION ThreadingHTTPServer this is the difference
    # between N long-lived handler threads for N clients and a fresh
    # TCP handshake + thread spawn PER REQUEST (the 1.0 default closes
    # after every response).
    protocol_version = "HTTP/1.1"

    # class attributes injected by make_server
    predictor: Predictor
    lock: threading.Lock
    stats: Dict[str, Any]
    stats_lock: threading.Lock
    batcher: Optional[DynamicBatcher] = None
    quiet: bool = True

    # ------------------------------------------------------------------
    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # noqa: D102 - BaseHTTPRequestHandler
        if not self.quiet:
            super().log_message(fmt, *args)

    def _read_json(self) -> Optional[Dict[str, Any]]:
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            self._reply(400, {"error": "missing or oversized request body"})
            return None
        try:
            payload = json.loads(self.rfile.read(length).decode("utf-8"))
        except Exception as exc:
            self._reply(400, {"error": f"invalid JSON: {exc}"})
            return None
        if not isinstance(payload, dict):
            # valid JSON but not an object ('[1,2]', '"x"', '5') would
            # otherwise AttributeError outside do_POST's try block and
            # drop the connection with no HTTP reply
            self._reply(400, {"error": "request body must be a JSON object"})
            return None
        return payload

    # ------------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        if self.path.rstrip("/") in ("", "/healthz"):
            dev = self.predictor.device
            with self.stats_lock:
                records_served = self.stats["records"]
                requests = self.stats["requests"]
            self._reply(
                200,
                {
                    "status": "ok",
                    "backend": dev.type,
                    "device": str(dev),
                    "device_name": (
                        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
                    ),
                    "records_served": records_served,
                    "requests": requests,
                },
            )
        elif self.path.rstrip("/") == "/stats":
            # how well dynamic batching coalesces (records per dispatch)
            # and the live queue depth (sustained growth: the device is
            # the bottleneck at the current load)
            b = self.batcher
            batcher_stats = None
            if b is not None:
                # counters snapshotted inside the same _cv block as the
                # queue depth so the triple is mutually consistent
                with b._cv:
                    queued = sum(len(e.records) for e in b._queue)
                    batches, records = b.batches, b.records
                batcher_stats = {
                    "dispatches": batches,
                    "records": records,
                    "avg_records_per_dispatch": (
                        round(records / batches, 2) if batches else None
                    ),
                    "queued_records": queued,
                    "window_ms": b.window_s * 1e3,
                    "gap_ms": b.gap_s * 1e3,
                    "max_batch": b.max_batch,
                }
            with self.stats_lock:
                requests = self.stats["requests"]
                records_served = self.stats["records"]
            self._reply(
                200,
                {
                    "requests": requests,
                    "records_served": records_served,
                    "batcher": batcher_stats,
                },
            )
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path not in ("/predict", "/explain"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        payload = self._read_json()
        if payload is None:
            return
        records = payload.get("records")
        if not isinstance(records, list):
            self._reply(400, {"error": "'records' must be a list"})
            return
        if self.path == "/explain":
            # numeric params validated HERE so a bad value is the
            # client's 400, not a NaN-producing or silently-degraded
            # 200 (a non-numeric n_coalitions would otherwise throw
            # inside kernel_shap and be caught by explain_shap's
            # smooth-grad fallback)
            try:
                top_k = int(payload.get("top_k", 8))
                n_coalitions = payload.get("n_coalitions")
                if n_coalitions is not None:
                    n_coalitions = int(n_coalitions)
                background_size = int(payload.get("background_size", 32))
                if background_size < 1:
                    raise ValueError("background_size must be >= 1")
            except (ValueError, TypeError) as exc:
                self._reply(400, {"error": f"bad explain params: {exc}"})
                return
        try:
            if self.path == "/predict" and self.batcher is not None:
                preds = self.batcher.submit(records)
            else:
                with self.lock:
                    if self.path == "/predict":
                        preds = self.predictor.predict(records)
                    else:
                        preds = self.predictor.explain(
                            records,
                            method=payload.get("method", "grad"),
                            top_k=top_k,
                            n_coalitions=n_coalitions,
                            background_size=background_size,
                        )
            with self.stats_lock:
                self.stats["requests"] += 1
                self.stats["records"] += len(preds)
        except ValueError as exc:  # bad method/params
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # scoring failure: report, stay up
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"predictions": preds})


def make_server(
    predictor: Predictor,
    host: str = "127.0.0.1",
    port: int = 8080,
    quiet: bool = True,
    batch_window_ms: Optional[float] = 4.0,
    max_batch: int = 4096,
    gap_ms: float = 3.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server bound to (host, port).

    Call `.serve_forever()` (blocking) or run it in a thread;
    `.shutdown()` stops it. Port 0 binds an ephemeral port
    (`server.server_address[1]` reports it) — used by the tests.

    `batch_window_ms`: dynamic-batching window for /predict — concurrent
    requests arriving within it score as one device dispatch (exact; see
    module docstring). `None` disables coalescing entirely (each request
    dispatches under the lock); 0 coalesces only what queued while the
    device was busy. The server's `.batcher` attribute exposes the
    dispatcher (`.batches` counts real dispatches; call `.close()` on
    teardown, as `ultrafnd_git_tpu_torch.serve` and the tests do).
    """
    lock = threading.Lock()
    handler = type(
        "BoundHandler",
        (_Handler,),
        {
            "predictor": predictor,
            "lock": lock,
            "stats": {"requests": 0, "records": 0},
            "stats_lock": threading.Lock(),
            "batcher": None,
            "quiet": quiet,
        },
    )

    class _Server(ThreadingHTTPServer):
        # stdlib default backlog is 5: a burst of concurrent clients
        # (exactly what dynamic batching is FOR) gets connection resets
        # before a handler thread ever sees them
        request_queue_size = 128

    # bind FIRST: a port-in-use failure must not leak a live batcher
    # worker thread (it would hold the Predictor forever)
    srv = _Server((host, port), handler)
    batcher = (
        None
        if batch_window_ms is None
        else DynamicBatcher(
            predictor, lock, max_batch=max_batch,
            window_ms=batch_window_ms, gap_ms=gap_ms,
        )
    )
    handler.batcher = batcher
    srv.batcher = batcher  # teardown hook for owners
    return srv
