"""Batch inference API and HTTP serving with dynamic batching (port of
the JAX ``eval/serving.py``: the plain, cycle and embedding variants, from
reference ``.pth`` checkpoints; the JAX package's orbax checkpoints are not
read here).

An ``Inpainter`` loads a reference ``.pth`` checkpoint, pads and buckets
incoming ragged sequences, runs the composite-inpainting forward on its
device, and returns each video with only its missing frames replaced.  A
threaded stdlib HTTP endpoint merges concurrent requests into shared
forwards (``RequestBatcher``).

POST /inpaint {"videos": [[[x, y] * 54] * T, ...],
               "masks": [[0/1] * T, ...]}
  -> {"videos": [...]}  (masked frames replaced by model predictions)
GET /healthz -> {"ok": true}
GET /statz   -> request, video and batch counts
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.keypoints import NUM_COORDS, NUM_KEYPOINTS
from ..models.completer import check_quantize
from ..models.convert import (is_embedding_state_dict, load_reference_pth,
                              state_dict_tensors)
from ..ops.losses import composite_prediction
from ..train.steps import build_model, completer_forward, cycle_forward
from ..transforms.corruption import add_sos, zero_missing_frames
from ..utils.config import ModelConfig, resolve_precision

VARIANTS = ("plain", "cycle", "embedding")


class Inpainter:
    """Checkpoint-backed masked-frame inpainting with shape bucketing.

    ``variant`` names what the checkpoint holds: "plain" (a KeypointCompleter
    of regime A1 or A4), "cycle" (regime A2's Cycle model, whose filled
    stream the frozen plain model ``first_state_dict`` predicts) or
    "embedding" (regime A3's autoencoder, which reconstructs the frames
    with the missing ones zeroed).  ``device`` is where the models run, the
    card unless the caller asks for the CPU: CUDA tensors go through the
    kernels, CPU tensors through their plain versions.  ``plain=True`` runs
    the plain versions on any device (the oracle path); ``merge_layers``
    False takes the per-sublayer kernels where the merged whole-layer ones
    would run.

    ``model_cfg.matmul_precision`` ("highest", "high", "default" or an
    alias) is the models' precision: the merged whole-layer kernels (T <=
    256, and the decoder's up to 512) run every product of the layer in its
    mode, and the FF and attention sublayers that run on their own
    (``merge_layers=False``, or a bucket the merged encoder layer does not
    take: 256 < T <= 512) run in it too, as do the per-op attention (T >
    512) and the pointwise chains' kernels (D a multiple of 128 up to 512,
    T a multiple of 8).  Int8 serving keeps its merged layers float32 at
    every precision; its per-sublayer and per-op attention and its
    pointwise chains run in the mode, as the JAX package's do.

    ``quantize="int8"`` serves int8 as the JAX package's Inpainter does on
    the TPU: the FF sublayers through the int8 FF kernels (the merged
    encoder layer in its int8-FF mode), every matmul that runs as a JAX
    ``nn.Dense`` there (the per-op attention projections, the pointwise
    chains off their kernels, the Embedding variant's two Linears) through
    the int8 dense layer, the rest in float32; both models of the Cycle
    variant.  The weights are quantized once, when the models are packed
    (``KeypointCompleter.pack_weights``); ``eval.quantize.
    quantization_error`` measures what int8 costs against float32."""

    def __init__(self, state_dict, model_cfg: ModelConfig,
                 bucket_multiple: int = 32, max_seq_len: int = 512,
                 variant: str = "plain", first_state_dict=None, device="cuda",
                 plain: bool = False, merge_layers: bool = True,
                 quantize: Optional[str] = None):
        quantize = check_quantize(quantize)
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}, expected one of "
                             f"{VARIANTS}")
        if variant == "cycle" and first_state_dict is None:
            raise ValueError("the cycle variant needs first_state_dict: the "
                             "frozen plain model that fills its stream")
        if model_cfg.compute_dtype != "float32":
            raise ValueError("the PyTorch port serves float32 only "
                             "(compute_dtype='float32')")
        resolve_precision(model_cfg.matmul_precision)
        self.device = torch.device(device)

        def load(v, sd):  # build_model raises on a missing card
            model = build_model(model_cfg, v, merge_layers=merge_layers,
                                device=self.device)
            model.load_state_dict(state_dict_tensors(sd))
            model.pack_weights(quantize)
            return model.eval()

        self.variant = variant
        self.model = load(variant, state_dict)
        self.first_model = load("plain", first_state_dict) \
            if variant == "cycle" else None
        self.plain = plain
        self.bucket = bucket_multiple
        self.max_seq_len = max_seq_len

    @classmethod
    def from_checkpoint(cls, path: str,
                        model_cfg: Optional[ModelConfig] = None,
                        first_checkpoint: Optional[str] = None,
                        precision: Optional[str] = None, **kw):
        """Load a reference ``.pth`` (and, for the cycle variant, the first
        model's ``.pth``); its hyperparameters (and the FF width of its
        first encoder layer, or an Embedding's widths) give the model
        configuration unless ``model_cfg`` is given.  ``precision``, when
        given, is its ``matmul_precision``."""
        sd, hyper = load_reference_pth(_pth(path))
        if model_cfg is None and is_embedding_state_dict(sd):
            hidden, size = sd["input_embedding.weight"].shape
            model_cfg = ModelConfig(hidden_dim=int(hidden),
                                    input_size=int(size))
        model_cfg = model_cfg or ModelConfig(
            hidden_dim=int(hyper["hidden_dim"]),
            num_layers=int(hyper["num_layers"]),
            num_heads=int(hyper["num_heads"]),
            input_size=int(hyper.get("input_size", 108)),
            ff_dim=int(sd["transformer.encoder.layers.0.linear1.weight"]
                       .shape[0]))
        if precision is not None:
            model_cfg = dataclasses.replace(model_cfg,
                                            matmul_precision=precision)
        if first_checkpoint is not None:
            kw["first_state_dict"] = load_reference_pth(
                _pth(first_checkpoint))[0]
        return cls(sd, model_cfg, **kw)

    @torch.inference_mode()
    def _run(self, clean: np.ndarray, miss: np.ndarray,
             valid: np.ndarray) -> np.ndarray:
        dev = self.device
        clean_t = torch.from_numpy(clean).to(dev)
        inputs, mask = add_sos(clean_t, torch.from_numpy(miss).to(dev))
        x, x_no = inputs[:, :-1], inputs[:, 1:]
        x_mask, y_mask = mask[:, :-1], mask[:, 1:]
        valid_t = torch.from_numpy(valid).to(dev)
        if self.variant == "embedding":
            # the autoencoder reconstructs the frame-aligned stream, the
            # missing frames zeroed first, as regimes A3 / A4 feed it
            pred = self.model(zero_missing_frames(x_no, y_mask), self.plain)
        elif self.variant == "cycle":
            pred = cycle_forward(self.first_model, self.model, x, x_no,
                                 x_mask, y_mask, valid_t, self.plain)
        else:
            pred = completer_forward(self.model, x, x_no, x_mask, y_mask,
                                     valid_t, self.plain)
        return composite_prediction(pred, clean_t, y_mask).cpu().numpy()

    def inpaint(self, videos: Sequence[np.ndarray],
                masks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """videos: ragged (T_i, 54, 2); masks: (T_i,) with 1 = missing.
        Missing frames may carry any placeholder; the model's predictions
        replace them.  Videos longer than ``max_seq_len`` are cut."""
        out: List[Optional[np.ndarray]] = [None] * len(videos)
        buckets = {}
        for i, v in enumerate(videos):
            t = min(len(v), self.max_seq_len)
            t_pad = min(((t + self.bucket - 1) // self.bucket) * self.bucket,
                        self.max_seq_len)
            buckets.setdefault(t_pad, []).append(i)
        for t_pad, idxs in buckets.items():
            B = len(idxs)
            clean = np.zeros((B, t_pad, NUM_KEYPOINTS, NUM_COORDS),
                             np.float32)
            miss = np.zeros((B, t_pad), np.float32)
            valid = np.zeros((B, t_pad), np.float32)
            for row, i in enumerate(idxs):
                t = min(len(videos[i]), t_pad)
                clean[row, :t] = videos[i][:t]
                miss[row, :t] = np.asarray(masks[i][:t])
                valid[row, :t] = 1.0
            res = self._run(clean, miss, valid)
            for row, i in enumerate(idxs):
                out[i] = res[row, :min(len(videos[i]), t_pad)]
        return out  # type: ignore[return-value]


def _pth(path: str) -> str:
    if not path.endswith(".pth"):
        raise ValueError("the PyTorch port loads reference .pth checkpoints "
                         f"only, got {path!r}")
    return path


class RequestBatcher:
    """Cross-request dynamic batching around the single device.

    Request handler threads enqueue (videos, masks) jobs; one worker thread
    drains the queue: after the first job arrives it keeps collecting for
    ``window_ms`` (or until ``max_batch_videos``) so that concurrent small
    requests ride the same forward.  The Inpainter's bucketing then groups
    the merged set by padded length.
    """

    def __init__(self, inpainter: Inpainter, max_batch_videos: int = 64,
                 window_ms: float = 3.0):
        self._inpainter = inpainter
        self._max = max_batch_videos
        self._window = window_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "videos": 0, "batches": 0,
                       "max_batch_videos": 0}
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def submit(self, videos, masks) -> concurrent.futures.Future:
        """Enqueue a job; returns a Future of List[np.ndarray]."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((videos, masks, fut))
        return fut

    def close(self):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5)
        # fail, rather than strand, any job still queued behind the sentinel
        while True:
            try:
                job = self._q.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                job[2].set_exception(RuntimeError("server shutting down"))

    def _loop(self):
        while not self._stop:
            first = self._q.get()
            if first is None:
                break
            jobs = [first]
            n = len(first[0])
            deadline = time.monotonic() + self._window
            while n < self._max:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=budget)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop = True
                    break
                jobs.append(nxt)
                n += len(nxt[0])
            videos = [v for vs, _, _ in jobs for v in vs]
            masks = [m for _, ms, _ in jobs for m in ms]
            try:
                res = self._inpainter.inpaint(videos, masks)
            except Exception as e:  # surface device errors to every caller
                for _, _, fut in jobs:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            with self._stats_lock:
                s = self._stats
                s["requests"] += len(jobs)
                s["videos"] += len(videos)
                s["batches"] += 1
                s["max_batch_videos"] = max(s["max_batch_videos"],
                                            len(videos))
            off = 0
            for vs, _, fut in jobs:
                if not fut.cancelled():
                    fut.set_result(res[off:off + len(vs)])
                off += len(vs)


def make_server(inpainter: Inpainter, host: str = "127.0.0.1",
                port: int = 8321, max_batch_videos: int = 64,
                window_ms: float = 3.0, request_timeout: float = 600.0,
                max_videos_per_request: int = 256,
                log_requests: bool = False):
    """Threaded HTTP server with dynamic batching; returns (server,
    batcher): call server.serve_forever(), then server.shutdown() and
    batcher.close()."""
    batcher = RequestBatcher(inpainter, max_batch_videos, window_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/statz":
                self._send(200, batcher.stats)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/inpaint":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                videos = [np.asarray(v, np.float32) for v in req["videos"]]
                masks = [np.asarray(m, np.float32) for m in req["masks"]]
                if len(videos) != len(masks):
                    raise ValueError("videos/masks length mismatch")
                if len(videos) > max_videos_per_request:
                    raise ValueError(
                        f"too many videos in one request "
                        f"({len(videos)} > {max_videos_per_request})")
                for v, m in zip(videos, masks):
                    if v.ndim != 3 or v.shape[1:] != (NUM_KEYPOINTS,
                                                      NUM_COORDS):
                        raise ValueError(
                            f"video must be (T, {NUM_KEYPOINTS}, "
                            f"{NUM_COORDS}), got {list(v.shape)}")
                    if m.ndim != 1 or len(m) != len(v):
                        raise ValueError("mask length != video length")
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            t0 = time.monotonic()
            fut = batcher.submit(videos, masks)
            try:
                res = fut.result(request_timeout)
            except concurrent.futures.TimeoutError:
                fut.cancel()  # drop it if the worker has not started it
                self._send(504, {"error": "inference timed out"})
                return
            except Exception as e:  # device/runtime errors -> HTTP 500
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"videos": [r.tolist() for r in res]})
            if log_requests:
                n_frames = sum(len(v) for v in videos)
                print(f"POST /inpaint videos={len(videos)} "
                      f"frames={n_frames} "
                      f"latency_ms={(time.monotonic() - t0) * 1e3:.1f}",
                      flush=True)

    server = ThreadingHTTPServer((host, port), Handler)
    return server, batcher


def serve(inpainter: Inpainter, host: str = "127.0.0.1", port: int = 8321,
          **kw):
    """Blocking HTTP serving around an Inpainter (threaded and batched);
    SIGTERM and SIGINT stop it."""
    server, batcher = make_server(inpainter, host, port, **kw)
    print(f"serving on http://{host}:{server.server_address[1]}", flush=True)

    def _shutdown(signum, frame):
        # serve_forever() must be stopped from another thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _shutdown)
        except ValueError:  # not the main thread
            pass
    try:
        server.serve_forever()
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        batcher.close()
        server.server_close()
