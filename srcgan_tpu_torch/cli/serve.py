"""HTTP serving daemon for the SR -> colorize cascade, as ``srcgan_tpu.cli.serve``.

  python -m srcgan_tpu_torch.cli.serve \\
      --netGA checkpoints/RDDBNet_A2C_x4_0050.npz \\
      --netGB checkpoints/ResDeconv_C2B_x4_0050.npz \\
      --port 8500 --bf16 --max-batch 8 --max-wait-ms 5

  POST /predict   body = PNG (gray or RGB; RGB is turned to luma on the
                  device) -> 200 with the SR RGB PNG
  POST /predict_scene  (with --tile N) body = PNG of ANY size -> SR RGB PNG;
                  the scene is cut into overlapping NxN windows, run in
                  batches of one tile shape and stitched
                  (serving.TiledPredictor)
  POST /reload    body = JSON {"netGA": path, "netGB": path} (either may be
                  omitted to re-read the file served now) -> swap the
                  weights of the same architecture with no downtime: the
                  new weights are loaded on the calling thread and installed
                  on the Batcher's worker thread between device groups, so no
                  request sees half-swapped weights.  Serves training epoch
                  saves and ``cli.blend`` outputs.  With --watch N the daemon
                  polls the served files every N seconds and reloads on a
                  change by itself (``save_params`` writes atomically, so a
                  poll never reads a torn file).
  GET  /healthz   -> JSON liveness + model config
  GET  /stats     -> JSON counters (requests, batches, mean batch size,
                     latency quantiles over a sliding window, and the
                     seconds summed over requests spent in PNG decode, in
                     the queue, in the group's forward and in PNG encode)
  GET  /metrics   -> the same counters in the Prometheus text exposition
                     format (srcgan_* counters and gauges)

Requests are micro-batched: a collector thread groups same-shaped requests
for up to --max-wait-ms (or --max-batch), runs ONE predictor call per group
(--pad-batch pads ragged groups to buckets, so the card sees a few batch
shapes and cuDNN chooses once per shape), and fans the outputs back out.
With --tile the predictor is a TiledPredictor: the Batcher's worker calls
its ``predict`` and scene requests call its ``predict_scene`` on their HTTP
thread, one object, so one set of modules on one CUDA stream.

Shutdown drains: ``Batcher.close()`` stops admitting requests (late submits
get a 503) but runs every queued group before the worker exits, so no
accepted request is dropped on SIGINT / SIGTERM.  Scene requests get the
same contract through ``SceneGate``.  Oversized bodies are rejected with 413
before the body is read (--max-request-mb).

With --mesh-size N the cascade runs over N ranks of a space mesh, a row
strip of each batch a rank (serving.SpatialShardedPredictor, or its tiled
form with --tile): this process is rank 0 and answers HTTP, and it starts
ranks 1..N-1 as local processes (one card each, or gloo on the CPU with
--device cpu) that follow its calls until it closes.  Under ``torchrun
--nproc-per-node N`` every rank runs the tool: rank 0 serves, the others
follow.  A follower that dies makes rank 0's next call raise.

Stdlib only (http.server + threading).  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
from collections import defaultdict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="SR cascade serving daemon")
    p.add_argument("--netGA", type=str, required=True)
    p.add_argument("--netGB", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 serving (the card's fast mode; default fp32, TF32 off)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--self-ensemble", action="store_true",
                   help="geometric self-ensemble (x8 dihedral TTA): every "
                        "request runs all D4 transforms as one batched "
                        "forward and averages them: higher quality at ~8x "
                        "the device FLOPs per request")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batching window")
    p.add_argument("--pad-batch", type=int, default=4,
                   help="pad group sizes to a multiple (few batch shapes); 0 disables")
    p.add_argument("--warmup", type=str, default=None,
                   help="comma-separated HxW gray input shapes to run at startup "
                        "(e.g. 128x128,256x256): every padded batch bucket once, "
                        "which builds the kernels and lets cuDNN choose at those "
                        "shapes before the first request")
    p.add_argument("--max-request-mb", type=float, default=16.0,
                   help="reject request bodies larger than this with 413")
    p.add_argument("--watch", type=float, default=0.0,
                   help="poll the served checkpoint files every N seconds and "
                        "hot-reload when they change on disk (0 = off)")
    p.add_argument("--tile", type=int, default=0,
                   help="enable POST /predict_scene: scenes of any size served "
                        "through one NxN tile shape (serving.TiledPredictor); "
                        "0 disables")
    p.add_argument("--mesh-size", type=int, default=0,
                   help="shard each batch's rows over N ranks of a space mesh "
                        "(serving.SpatialShardedPredictor); this process is rank 0")
    p.add_argument("--tile-overlap", type=int, default=32,
                   help="tile halo cropped from each output tile; >= the "
                        "cascade's receptive-field radius makes stitching "
                        "exact against a whole-image call")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


class ShuttingDown(RuntimeError):
    """Raised by Batcher.submit once close() has begun (HTTP 503)."""


def _quantiles(lat, qs, prefix=""):
    if not lat:
        return {}
    xs = np.sort(np.asarray(lat))
    return {f"{prefix}p{round(q * 100)}_s": round(float(xs[min(len(xs) - 1, int(q * len(xs)))]), 4)
            for q in qs}


class SceneGate:
    """Drain accounting for /predict_scene requests, which bypass the
    Batcher (TiledPredictor batches its own tiles): new requests are 503'd
    once shutdown begins, and close() waits for every in-flight scene."""

    def __init__(self):
        self._lock = threading.Condition()
        self._inflight = 0
        self._stop = False
        self.stats = {"scene_requests": 0, "scene_errors": 0}
        self._lat = deque(maxlen=512)
        # per-thread start time: concurrent HTTP threads enter the gate
        self._local = threading.local()

    def __enter__(self):
        with self._lock:
            if self._stop:
                raise ShuttingDown("server is shutting down")
            self._inflight += 1
            self.stats["scene_requests"] += 1
        self._local.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        with self._lock:
            self._inflight -= 1
            if et is None:
                self._lat.append(time.perf_counter() - self._local.t0)
            else:
                self.stats["scene_errors"] += 1
            self._lock.notify_all()
        return False

    def latency_quantiles(self):
        return _quantiles(self._lat, (0.5, 0.99), "scene_")

    def close(self, timeout: float = 600.0):
        with self._lock:
            self._stop = True
            deadline = time.monotonic() + timeout
            while self._inflight and time.monotonic() < deadline:
                self._lock.wait(timeout=deadline - time.monotonic())


class _Request:
    __slots__ = ("img", "event", "out", "err", "t0")

    def __init__(self, img):
        self.img = img
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.t0 = time.perf_counter()


class Batcher:
    """Groups same-shaped requests into one predictor call, on one worker
    thread: the only thread that calls the predictor's ``predict`` (scene
    threads call ``predict_scene``), so its per-thread scopes
    (``quant.quant_mode`` of an int8 predictor, ``rdb5_schedule``) are the
    predictor's own, entered inside ``predict``."""

    def __init__(self, predictor, max_batch: int = 8, max_wait_s: float = 0.005):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._lock = threading.Condition()
        self._queues = defaultdict(deque)   # (h, w, c) -> deque[_Request]
        self._control = deque()             # (fn, result_box, done_event)
        self._stop = False
        self.stats = {"requests": 0, "batches": 0, "batched_samples": 0, "errors": 0,
                      "queue_seconds": 0.0, "forward_seconds": 0.0}
        self._lat = deque(maxlen=512)
        self._thread = threading.Thread(target=self._run, daemon=True, name="batcher")
        self._thread.start()

    def submit(self, img: np.ndarray) -> np.ndarray:
        req = _Request(img)
        with self._lock:
            if self._stop:
                raise ShuttingDown("server is shutting down")
            self._queues[img.shape].append(req)
            self.stats["requests"] += 1
            self._lock.notify()
        req.event.wait()
        if req.err is not None:
            raise req.err
        self._lat.append(time.perf_counter() - req.t0)
        return req.out

    def latency_quantiles(self):
        return _quantiles(self._lat, (0.5, 0.9, 0.99))

    def run_in_worker(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the batching worker thread, between device groups.

        The worker is the only ``predict()`` caller, so predictor mutation
        here (a checkpoint hot-reload) races with no group.  Returns fn's
        result or re-raises its exception in the calling thread."""
        done = threading.Event()
        box = {}
        with self._lock:
            if self._stop:
                raise ShuttingDown("server is shutting down")
            self._control.append((fn, box, done))
            self._lock.notify_all()
        if not done.wait(timeout):
            raise TimeoutError(f"batcher worker did not run the action within {timeout}s")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def close(self, drain: bool = True, timeout: float = 60.0):
        """Stop admitting requests; by default run every queued group first.

        With ``drain=False`` (or on join timeout) the remaining waiters are
        failed with ShuttingDown instead of being left hanging."""
        with self._lock:
            self._stop = True
            if not drain:
                self._fail_queued_locked()
            self._lock.notify_all()
        self._thread.join(timeout=timeout)
        with self._lock:
            self._fail_queued_locked()

    def _fail_queued_locked(self):
        for q in self._queues.values():
            for r in q:
                r.err = ShuttingDown("server shut down before running this request")
                r.event.set()
        self._queues.clear()
        for _, box, done in self._control:
            box["err"] = ShuttingDown("server shut down before running this action")
            done.set()
        self._control.clear()

    def _take_group(self):
        """Largest same-shape group, capped at max_batch (holds the lock)."""
        if not any(self._queues.values()):
            return None
        shape = max(self._queues, key=lambda s: len(self._queues[s]))
        q = self._queues[shape]
        group = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        if not q:
            del self._queues[shape]
        return group

    def _run(self):
        while True:
            ctl = group = None
            with self._lock:
                while (not self._stop and not any(self._queues.values())
                       and not self._control):
                    self._lock.wait()
                if self._control:
                    # control actions jump the queue (a reload should not
                    # wait out a deep backlog; running groups have finished)
                    ctl = self._control.popleft()
                elif self._stop and not any(self._queues.values()):
                    break  # drained: nothing queued remains
                else:
                    if not self._stop:
                        # micro-batching window: wait for stragglers of any shape
                        deadline = time.monotonic() + self.max_wait_s
                        while (not self._stop and not self._control
                               and sum(map(len, self._queues.values())) < self.max_batch
                               and time.monotonic() < deadline):
                            self._lock.wait(timeout=deadline - time.monotonic())
                        if self._control:
                            ctl = self._control.popleft()
                    if ctl is None:
                        group = self._take_group()
            if ctl is not None:
                fn, box, done = ctl
                try:
                    box["out"] = fn()
                except Exception as e:  # noqa: BLE001 - handed to the caller
                    box["err"] = e
                finally:
                    done.set()
                continue
            if not group:
                continue
            t_run = time.perf_counter()
            try:
                outs = self.predictor.predict(np.stack([r.img for r in group]))
                for r, o in zip(group, outs):
                    r.out = o
            except Exception as e:  # noqa: BLE001 - surfaced to every waiter
                for r in group:
                    r.err = e
                self.stats["errors"] += 1
            finally:
                # summed over requests: each waits in the queue, then for its
                # group's whole forward
                self.stats["queue_seconds"] += sum(t_run - r.t0 for r in group)
                self.stats["forward_seconds"] += (time.perf_counter() - t_run) * len(group)
                self.stats["batches"] += 1
                self.stats["batched_samples"] += len(group)
                for r in group:
                    r.event.set()


def make_reloader(batcher, config, tiled_lock):
    """A serialised do_reload(netGA, netGB) closure shared by the /reload
    endpoint and the --watch poller.  None arguments mean "re-read the
    currently served path".  The new weights are installed on the Batcher's
    worker between groups and under the scene lock, so neither a group nor
    a scene sees half-swapped weights."""
    reload_lock = threading.Lock()

    def do_reload(ga=None, gb=None):
        with reload_lock:
            ga = ga or config["netGA"]
            gb = gb or config["netGB"]
            install = batcher.predictor.reload_checkpoints(ga, gb)

            def install_between_scenes():
                with tiled_lock:
                    install()

            batcher.run_in_worker(install_between_scenes)
            config["netGA"], config["netGB"] = ga, gb
            batcher.stats["reloads"] = batcher.stats.get("reloads", 0) + 1
        return ga, gb

    return do_reload


def make_watcher(batcher, config, do_reload, interval: float):
    """Daemon thread polling the served checkpoint files' (mtime_ns, size);
    on a change, hot-reload through ``do_reload``.  A failed load (a writer
    caught mid-write) counts as a watch_error and retries on the next tick
    while the old weights keep serving.  Returns a stop Event."""
    stop = threading.Event()

    def sig():
        try:
            out = []
            for p in (config["netGA"], config["netGB"]):
                st = os.stat(p)
                out.append((st.st_mtime_ns, st.st_size))
            return tuple(out)
        except OSError:
            return None

    def loop():
        last = sig()
        while not stop.wait(interval):
            cur = sig()
            if cur is None or cur == last:
                continue
            try:
                do_reload()
                last = sig()
                batcher.stats["watch_reloads"] = batcher.stats.get("watch_reloads", 0) + 1
                print(f"watch: reloaded {config['netGA']} + {config['netGB']}")
            except ShuttingDown:
                return
            except Exception as e:  # noqa: BLE001 - keep serving the old weights
                batcher.stats["watch_errors"] = batcher.stats.get("watch_errors", 0) + 1
                print(f"watch: reload failed ({e}); retrying next tick")

    threading.Thread(target=loop, daemon=True, name="ckpt-watch").start()
    return stop


def make_handler(batcher, config, tiled=None, scene_gate=None, do_reload=None,
                 tiled_lock=None):
    # a lock keeps concurrent scene requests from interleaving their tile
    # streams on the card
    if tiled_lock is None:
        tiled_lock = threading.Lock()
    if do_reload is None:
        do_reload = make_reloader(batcher, config, tiled_lock)
    # PNG codec seconds summed over answered requests, beside the Batcher's
    # queue and forward seconds
    codec_lock = threading.Lock()
    codec = {"decode_seconds": 0.0, "encode_seconds": 0.0}

    def add_codec(key, seconds):
        with codec_lock:
            codec[key] += seconds

    class Handler(BaseHTTPRequestHandler):
        # headers and body go out as two writes: with Nagle's algorithm the
        # body's last segment can wait for the client's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet; /stats has counters
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _collect_stats(self):
            s = dict(batcher.stats)
            with codec_lock:
                s.update(codec)
            if s["batches"]:
                s["mean_batch"] = round(s["batched_samples"] / s["batches"], 2)
            s.update(batcher.latency_quantiles())
            if scene_gate is not None:
                s.update(scene_gate.stats)
                s.update(scene_gate.latency_quantiles())
            return s

        def _body_length(self):
            """The request's Content-Length, or None after answering 413: a
            negative length would make rfile.read(n) read to EOF, unbounded."""
            n = int(self.headers.get("Content-Length", "0"))
            if n < 0 or n > config["max_request_bytes"]:
                # rejected before the body is read; the unread body makes the
                # connection unusable, so close it
                self.close_connection = True
                self._json(413, {"error": f"request body too large ({n} > "
                                          f"{config['max_request_bytes']} bytes)"})
                return None
            return n

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **config})
            elif self.path == "/stats":
                self._json(200, self._collect_stats())
            elif self.path == "/metrics":
                # Prometheus text exposition: monotonic totals are counters;
                # latency quantiles (keys ending in _s, seconds) and the mean
                # batch size are gauges
                lines = []
                for k, v in sorted(self._collect_stats().items()):
                    if not isinstance(v, (int, float)):
                        continue
                    typ = "gauge" if k.endswith("_s") or k == "mean_batch" else "counter"
                    lines += [f"# TYPE srcgan_{k} {typ}", f"srcgan_{k} {v}"]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                self._reload()
                return
            if self.path not in ("/predict", "/predict_scene"):
                self._json(404, {"error": "unknown path"})
                return
            if self.path == "/predict_scene" and tiled is None:
                self._json(404, {"error": "scene serving disabled; start the daemon with --tile"})
                return
            try:
                n = self._body_length()
                if n is None:
                    return
                from PIL import Image

                body = self.rfile.read(n)
                t0 = time.perf_counter()
                img = np.asarray(Image.open(io.BytesIO(body)))
                t_decoded = time.perf_counter()
                if img.dtype != np.uint8:
                    raise ValueError("PNG must be 8-bit")
                if img.ndim == 2:
                    img = img[..., None]
                if self.path == "/predict_scene":
                    with scene_gate, tiled_lock:
                        out = tiled.predict_scene(img)
                else:
                    out = batcher.submit(img)
                t1 = time.perf_counter()
                buf = io.BytesIO()
                Image.fromarray(out).save(buf, format="PNG")
                body = buf.getvalue()
                add_codec("decode_seconds", t_decoded - t0)
                add_codec("encode_seconds", time.perf_counter() - t1)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except ShuttingDown as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the client's error, reported
                self._json(400, {"error": str(e)})

        def _reload(self):
            """Checkpoint hot-reload: body = JSON {"netGA": ..., "netGB": ...}
            (either may be omitted to re-read the path served now).  Same
            architecture only; no dropped requests (the install runs on the
            Batcher worker between groups and under the scene lock)."""
            try:
                n = self._body_length()
                if n is None:
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                t0 = time.perf_counter()
                ga, gb = do_reload(body.get("netGA"), body.get("netGB"))
                self._json(200, {"reloaded": True, "netGA": ga, "netGB": gb,
                                 "seconds": round(time.perf_counter() - t0, 3)})
            except ShuttingDown as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - the client's error, reported
                self._json(400, {"error": str(e)})

    return Handler


def _warm(pred, args):
    """Run every padded batch bucket once at each --warmup shape (and the
    scene tile), so the first requests find the kernels built and cuDNN's
    choices made."""
    if args.pad_batch:
        nb = -(-args.max_batch // args.pad_batch)
        sizes = {args.pad_batch * i for i in range(1, nb + 1)}
    else:
        sizes = {1, args.max_batch}
    for spec in args.warmup.split(","):
        h, w = (int(v) for v in spec.lower().split("x"))
        for n in sorted(sizes):
            t0 = time.perf_counter()
            pred.predict(np.zeros((n, h, w, 1), np.uint8))
            print(f"warmed {n}x{h}x{w} in {time.perf_counter() - t0:.1f}s")


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the connections
    # of a burst of clients beyond it, and each dropped client retries its
    # connection after a second or more
    request_queue_size = 256


def _predictor(args, device, mesh=None, followers=None):
    """The daemon's predictor: with --tile one TiledPredictor serves both
    endpoints (one set of modules on one CUDA stream); with a mesh, their
    space-sharded forms."""
    from srcgan_tpu_torch import serving

    kw = ({"tile": args.tile, "overlap": args.tile_overlap, "max_batch": args.max_batch}
          if args.tile else {})
    if mesh is not None:
        cls = serving.SpatialShardedTiledPredictor if args.tile else serving.SpatialShardedPredictor
        kw.update(mesh=mesh, followers=followers)
    else:
        cls = serving.TiledPredictor if args.tile else serving.CascadePredictor
    return cls.from_checkpoints(
        args.netGA, args.netGB, bf16=args.bf16, pad_batch_to=args.pad_batch,
        self_ensemble=args.self_ensemble, device=device, **kw)


def _in_torchrun(args) -> bool:
    return args.mesh_size > 1 and "WORLD_SIZE" in os.environ


def follow(argv) -> None:
    """A follower rank of ``--mesh-size``: the predictor rank 0 built, on
    this rank's device, serving rank 0's calls until it closes."""
    args = argv[0] if isinstance(argv[0], argparse.Namespace) else argparse.Namespace(**argv[0])
    from srcgan_tpu_torch import parallel

    mesh = parallel.make_mesh((args.mesh_size,), ("space",), device=args.device)
    _predictor(args, mesh.device, mesh).follow()


def make_server(args) -> ThreadingHTTPServer:
    from srcgan_tpu_torch import config as tconfig

    mesh = followers = None
    if args.mesh_size > 1:
        from srcgan_tpu_torch import parallel
        from srcgan_tpu_torch.parallel import mesh as mesh_lib

        if _in_torchrun(args):
            mesh = parallel.make_mesh((args.mesh_size,), ("space",), device=args.device)
            if not mesh.is_main:
                raise SystemExit("make_server runs on rank 0; the other ranks run follow()")
        else:
            mesh, followers = mesh_lib.lead("srcgan_tpu_torch.cli.serve:follow", [vars(args)],
                                            args.mesh_size, ("space",), args.device)
        device = mesh.device
    else:
        device = tconfig.resolve_device(args.device)
    try:
        pred = _predictor(args, device, mesh, followers)
    except BaseException:
        if followers is not None:
            followers.kill()
        raise
    if args.warmup:
        _warm(pred, args)
    tiled = pred if args.tile else None
    if args.tile and args.warmup:
        for ch in (1, 3):
            t0 = time.perf_counter()
            tiled.predict(np.zeros((args.max_batch, args.tile, args.tile, ch), np.uint8))
            print(f"warmed scene tile {args.max_batch}x{args.tile}x{args.tile}x{ch} "
                  f"in {time.perf_counter() - t0:.1f}s")
    batcher = Batcher(pred, max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3)
    config = {"netGA": args.netGA, "netGB": args.netGB, "up": pred.up,
              "lab": pred.lab, "bf16": pred.bf16, "max_batch": args.max_batch,
              "device": str(device), "mesh_size": max(args.mesh_size, 1),
              "max_request_bytes": int(args.max_request_mb * 1024 * 1024),
              **({"tile": args.tile, "tile_overlap": args.tile_overlap}
                 if args.tile else {})}
    scene_gate = SceneGate() if tiled is not None else None
    tiled_lock = threading.Lock()
    do_reload = make_reloader(batcher, config, tiled_lock)
    srv = _Server(
        (args.host, args.port),
        make_handler(batcher, config, tiled=tiled, scene_gate=scene_gate,
                     do_reload=do_reload, tiled_lock=tiled_lock))
    srv.batcher = batcher
    srv.pred, srv.followers = pred, followers
    srv.scene_gate = scene_gate
    srv.tiled = tiled
    srv.do_reload = do_reload
    srv.watch_stop = (make_watcher(batcher, config, do_reload, args.watch)
                      if args.watch > 0 else None)
    return srv


def close(srv) -> None:
    """Drain and stop what ``make_server`` started (the HTTP loop must have
    been stopped with ``srv.shutdown()`` first, or never run)."""
    if srv.watch_stop is not None:
        srv.watch_stop.set()
    srv.batcher.close()
    if srv.scene_gate is not None:
        srv.scene_gate.close()  # wait out in-flight scenes too
    srv.server_close()
    if hasattr(srv.pred, "follow"):
        srv.pred.stop()
        if srv.followers is not None:
            srv.followers.join()
        else:
            from srcgan_tpu_torch.parallel import destroy_mesh
            destroy_mesh()


def main(argv=None):
    import signal

    args = build_parser().parse_args(argv)
    if _in_torchrun(args) and int(os.environ.get("RANK", 0)) != 0:
        try:
            return follow([args])
        finally:
            from srcgan_tpu_torch.parallel import destroy_mesh
            destroy_mesh()
    srv = make_server(args)
    host, port = srv.server_address[:2]
    print(f"serving on http://{host}:{port}  (POST /predict, GET /healthz, GET /stats)")
    # SIGTERM (systemd / k8s stop) takes the same drain path as Ctrl-C;
    # shutdown() must not run on the serve_forever thread (it joins it)
    prev = signal.signal(signal.SIGTERM, lambda s, f: threading.Thread(
        target=srv.shutdown, daemon=True).start())
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        close(srv)


if __name__ == "__main__":
    main()
