"""The port's HTTP serving daemon (``cli.serve``) end to end over a real
socket, on the CPU: ESPCN x2 + SRCNN checkpoints written in the JAX
package's .npz layout, the server on an ephemeral port.

Every HTTP call and every join has a timeout of 30 s or less.  A served
image equals ``predict`` of the same image on a predictor built from the
same files (one program, one device: bit for bit).
"""
from __future__ import annotations

import http.client
import io
import json
import os
import socket
import threading
import time
from collections import defaultdict, deque

import numpy as np
import pytest
import torch
from PIL import Image

from srcgan_tpu_torch import config, models
from srcgan_tpu_torch.cli import serve
from srcgan_tpu_torch.interop import jax_tree_from_module
from srcgan_tpu_torch.serving import CascadePredictor, TiledPredictor
from srcgan_tpu_torch.train.state import checkpoint_name, save_params

TIMEOUT = 30


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_ckpts(d, epoch, seed):
    """An ESPCN x2 + SRCNN pair under reference names, weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for net, name, role in ((models.ESPCN(1, 1, 2, generator=gen), "ESPCN", "A2C"),
                            (models.SRCNN(1, 3, 1, generator=gen), "SRCNN", "C2B")):
        path = os.path.join(str(d), checkpoint_name(name, role, 2, epoch))
        save_params(path, jax_tree_from_module(net)[0])
        out.append(path)
    return tuple(out)


def start(ckpts, *flags):
    args = serve.build_parser().parse_args(
        ["--netGA", ckpts[0], "--netGB", ckpts[1], "--port", "0", "--device", "cpu", *flags])
    srv = serve.make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def stop(srv):
    srv.shutdown()
    serve.close(srv)


def png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def post_png(port, img, path="/predict"):
    status, ctype, data = request(port, "POST", path, png(img))
    out = np.asarray(Image.open(io.BytesIO(data))) if status == 200 else None
    return status, ctype, out


def post_json(port, path, obj):
    status, _, data = request(port, "POST", path, json.dumps(obj).encode())
    return status, json.loads(data)


def get_json(port, path):
    status, _, data = request(port, "GET", path)
    assert status == 200
    return json.loads(data)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_ckpts(tmp_path_factory.mktemp("serve_ck"), 3, 0)


@pytest.fixture(scope="module")
def server(ckpts):
    srv = start(ckpts, "--max-batch", "4", "--max-wait-ms", "30", "--pad-batch", "0")
    yield srv
    stop(srv)


@pytest.fixture(scope="module")
def reference(ckpts):
    return CascadePredictor.from_checkpoints(*ckpts, device="cpu")


def test_healthz(server):
    body = get_json(server.server_address[1], "/healthz")
    assert body["ok"] and body["up"] == 2 and body["max_batch"] == 4
    assert body["device"] == "cpu" and "tile" not in body


def test_predict_gray_and_rgb_concurrent(server, reference):
    port = server.server_address[1]
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    results = {}

    def call(key, img):
        results[key] = post_png(port, img)

    threads = ([threading.Thread(target=call, args=(f"g{i}", gray)) for i in range(3)]
               + [threading.Thread(target=call, args=("rgb", rgb))])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    for key, (status, ctype, out) in results.items():
        assert status == 200 and ctype == "image/png", key
        assert out.shape == (32, 32, 3) and out.dtype == np.uint8
    want_gray = reference.predict(gray[None, ..., None])[0]
    for i in range(3):
        np.testing.assert_array_equal(results[f"g{i}"][2], want_gray)
    np.testing.assert_array_equal(results["rgb"][2], reference.predict(rgb[None])[0])


def test_stats_counters(server):
    for _ in range(2):
        assert post_png(server.server_address[1], np.zeros((8, 8), np.uint8))[0] == 200
    s = get_json(server.server_address[1], "/stats")
    assert s["requests"] >= 2 and s["batches"] >= 1
    assert s["batched_samples"] >= s["batches"] and s["mean_batch"] >= 1
    assert {"p50_s", "p90_s", "p99_s"} <= set(s)
    for k in ("decode_seconds", "queue_seconds", "forward_seconds", "encode_seconds"):
        assert s[k] > 0, k


def test_metrics_prometheus_exposition(server):
    port = server.server_address[1]
    for _ in range(4):
        assert post_png(port, np.zeros((8, 8), np.uint8))[0] == 200
    status, ctype, data = request(port, "GET", "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    text = data.decode()
    for name, typ in (("requests", "counter"), ("batches", "counter"),
                      ("batched_samples", "counter"), ("errors", "counter"),
                      ("mean_batch", "gauge"), ("p50_s", "gauge"), ("p99_s", "gauge")):
        assert f"# TYPE srcgan_{name} {typ}" in text, name
    samples = {ln.split()[0]: float(ln.split()[1])
               for ln in text.splitlines() if not ln.startswith("#")}
    assert samples["srcgan_requests"] >= 4
    assert samples["srcgan_batched_samples"] >= samples["srcgan_batches"]


def test_bad_body_is_a_400_not_a_crash(server):
    port = server.server_address[1]
    status, _, data = request(port, "POST", "/predict", b"this is not a png")
    assert status == 400 and "error" in json.loads(data)
    assert post_png(port, np.zeros((8, 8), np.uint8))[0] == 200


def test_unknown_paths_are_404(server):
    port = server.server_address[1]
    assert request(port, "GET", "/nope")[0] == 404
    assert request(port, "POST", "/nope", b"")[0] == 404
    status, _, data = request(port, "POST", "/predict_scene", png(np.zeros((48, 64), np.uint8)))
    assert status == 404 and b"--tile" in data


def test_oversized_request_is_413_before_reading_body(server):
    port = server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.putrequest("POST", "/predict")
    conn.putheader("Content-Length", str(64 * 1024 * 1024))   # 64 MB > 16 MB
    conn.endheaders()                                          # the body never comes
    r = conn.getresponse()
    assert r.status == 413 and b"too large" in r.read()
    conn.close()
    assert post_png(port, np.zeros((8, 8), np.uint8))[0] == 200


@pytest.mark.parametrize("path", ["/predict", "/reload"])
def test_negative_content_length_is_413(server, path):
    s = socket.create_connection(("127.0.0.1", server.server_address[1]), timeout=TIMEOUT)
    try:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n".encode())
        first = s.recv(4096).split(b"\r\n")[0]
    finally:
        s.close()
    assert b" 413 " in first + b" ", first


def test_predict_scene_tiled(tmp_path, ckpts):
    """--tile enables /predict_scene: a scene of any size, stitched, equal to
    the TiledPredictor on the same files; scene traffic in /stats."""
    srv = start(ckpts, "--max-batch", "4", "--tile", "28", "--tile-overlap", "10")
    try:
        port = srv.server_address[1]
        assert isinstance(srv.tiled, TiledPredictor)
        assert srv.tiled is srv.batcher.predictor   # one predictor for both endpoints
        scene = np.random.default_rng(8).integers(0, 256, (48, 64), dtype=np.uint8)
        status, _, out = post_png(port, scene, "/predict_scene")
        assert status == 200 and out.shape == (96, 128, 3)
        ref = CascadePredictor.from_checkpoints(*ckpts, device="cpu")
        want = TiledPredictor(ref.sr_model, ref.c_model, 2, tile=28, overlap=10, max_batch=4,
                              device="cpu").predict_scene(scene)
        np.testing.assert_array_equal(out, want)
        h = get_json(port, "/healthz")
        assert h["tile"] == 28 and h["tile_overlap"] == 10
        s = get_json(port, "/stats")
        assert s["scene_requests"] == 1 and s["scene_errors"] == 0 and "scene_p50_s" in s
    finally:
        stop(srv)


def test_close_drains_queued_requests():
    """close() runs every accepted request; a late submit gets ShuttingDown."""
    class SlowPredictor:
        def predict(self, batch):
            time.sleep(0.05)
            return batch

    b = serve.Batcher(SlowPredictor(), max_batch=1, max_wait_s=0.0)
    outs, errs = {}, {}

    def call(i):
        try:
            outs[i] = b.submit(np.full((4, 4, 1), i, np.uint8))
        except Exception as e:  # noqa: BLE001 - recorded for the assertions
            errs[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while b.stats["requests"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert b.stats["requests"] == 3
    b.close(timeout=TIMEOUT)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not errs and sorted(outs) == [0, 1, 2]
    for i, o in outs.items():
        np.testing.assert_array_equal(o, np.full((4, 4, 1), i, np.uint8))
    with pytest.raises(serve.ShuttingDown):
        b.submit(np.zeros((4, 4, 1), np.uint8))


def test_close_without_drain_fails_the_queue():
    release = threading.Event()

    class Blocked:
        def predict(self, batch):
            release.wait(TIMEOUT)
            return batch

    b = serve.Batcher(Blocked(), max_batch=1, max_wait_s=0.0)
    errs = []

    def call():
        try:
            b.submit(np.zeros((2, 2, 1), np.uint8))
        except serve.ShuttingDown as e:
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 10
    while b.stats["requests"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    closer = threading.Thread(target=b.close, kwargs={"drain": False, "timeout": TIMEOUT})
    closer.start()
    time.sleep(0.05)
    release.set()
    closer.join(timeout=TIMEOUT)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert not closer.is_alive() and len(errs) == 2       # the running group finished


def test_scene_gate_drains_and_503s():
    gate = serve.SceneGate()
    entered, done = threading.Event(), threading.Event()

    def scene():
        with gate:
            entered.set()
            time.sleep(0.3)
            done.set()

    t = threading.Thread(target=scene)
    t.start()
    assert entered.wait(TIMEOUT)
    closer = threading.Thread(target=gate.close, kwargs={"timeout": TIMEOUT})
    closer.start()
    deadline = time.monotonic() + 10
    while not gate._stop and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(serve.ShuttingDown):
        gate.__enter__()                     # a new scene during the drain
    closer.join(timeout=TIMEOUT)
    assert not closer.is_alive() and done.is_set()
    assert gate.stats["scene_requests"] == 1 and "scene_p50_s" in gate.latency_quantiles()
    t.join(timeout=TIMEOUT)


def test_run_in_worker_is_serialized_with_groups():
    seen = []

    class P:
        def predict(self, batch):
            seen.append(("predict", threading.get_ident()))
            time.sleep(0.02)
            return batch

    b = serve.Batcher(P(), max_batch=1, max_wait_s=0.0)
    try:
        assert b.submit(np.zeros((4, 4, 1), np.uint8)).shape == (4, 4, 1)

        def action():
            seen.append(("action", threading.get_ident()))
            return 42

        assert b.run_in_worker(action, timeout=TIMEOUT) == 42
        assert len({tid for _, tid in seen}) == 1            # both on the worker thread
        with pytest.raises(RuntimeError, match="boom"):
            b.run_in_worker(lambda: (_ for _ in ()).throw(RuntimeError("boom")), timeout=TIMEOUT)
    finally:
        b.close(timeout=TIMEOUT)
    with pytest.raises(serve.ShuttingDown):
        b.run_in_worker(lambda: None)


def test_take_group_takes_the_largest_shape_up_to_max_batch():
    b = serve.Batcher.__new__(serve.Batcher)
    b.max_batch = 2
    b._queues = defaultdict(deque)
    for shape, n in (((4, 4, 1), 1), ((8, 8, 1), 3)):
        for _ in range(n):
            b._queues[shape].append(serve._Request(np.zeros(shape, np.uint8)))
    assert [r.img.shape for r in b._take_group()] == [(8, 8, 1)] * 2
    assert [r.img.shape for r in b._take_group()] == [(4, 4, 1)]
    assert [r.img.shape for r in b._take_group()] == [(8, 8, 1)]
    assert b._take_group() is None


def test_reload_hot_swaps_weights(tmp_path):
    """/reload: new weights serve at once, /healthz follows, a checkpoint of
    another scale is a 400 that leaves the weights serving, an empty body
    re-reads the served files; the scene predictor follows the swap."""
    ck1, ck2 = write_ckpts(tmp_path, 1, 0), write_ckpts(tmp_path, 2, 1)
    bad = os.path.join(str(tmp_path), checkpoint_name("ESPCN", "A2C", 4, 1))
    save_params(bad, jax_tree_from_module(models.ESPCN(1, 1, 4))[0])
    srv = start(ck1, "--max-batch", "4", "--pad-batch", "0", "--tile", "28",
                "--tile-overlap", "10")
    try:
        port = srv.server_address[1]
        img = np.random.default_rng(3).integers(0, 256, (16, 16), dtype=np.uint8)
        out1 = post_png(port, img)[2]
        status, body = post_json(port, "/reload", {"netGA": ck2[0], "netGB": ck2[1]})
        assert status == 200 and body["reloaded"] and body["netGA"] == ck2[0]
        out2 = post_png(port, img)[2]
        np.testing.assert_array_equal(
            out2, CascadePredictor.from_checkpoints(*ck2, device="cpu").predict(
                img[None, ..., None])[0])
        assert not np.array_equal(out1, out2)
        assert srv.tiled is srv.batcher.predictor
        np.testing.assert_array_equal(post_png(port, img, "/predict_scene")[2], out2)
        h = get_json(port, "/healthz")
        assert h["netGA"] == ck2[0] and h["netGB"] == ck2[1]
        status, body = post_json(port, "/reload", {"netGA": bad})
        assert status == 400 and "x4" in body["error"]
        np.testing.assert_array_equal(post_png(port, img)[2], out2)
        status, body = post_json(port, "/reload", {})
        assert status == 200 and body["netGA"] == ck2[0]
        np.testing.assert_array_equal(post_png(port, img)[2], out2)
        assert get_json(port, "/stats")["reloads"] == 2
    finally:
        stop(srv)


def test_watch_auto_reloads_on_file_change(tmp_path):
    ga, gb = write_ckpts(tmp_path, 1, 0)
    srv = start((ga, gb), "--pad-batch", "0", "--watch", "0.1")
    try:
        port = srv.server_address[1]
        img = np.random.default_rng(4).integers(0, 256, (16, 16), dtype=np.uint8)
        out1 = post_png(port, img)[2]
        new = write_ckpts(tmp_path / "new", 1, 5)
        for src, dst in zip(new, (ga, gb)):
            os.replace(src, dst)                  # an atomic overwrite, as save_params does
        deadline = time.monotonic() + 20
        while srv.batcher.stats.get("watch_reloads", 0) < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.batcher.stats.get("watch_reloads", 0) >= 1
        assert not np.array_equal(out1, post_png(port, img)[2])
    finally:
        stop(srv)


def test_warmup_runs_every_padded_bucket(ckpts, monkeypatch):
    seen = []
    predict = CascadePredictor.predict

    def spy(self, x):
        seen.append(x.shape)
        return predict(self, x)

    monkeypatch.setattr(CascadePredictor, "predict", spy)
    srv = serve.make_server(serve.build_parser().parse_args(
        ["--netGA", ckpts[0], "--netGB", ckpts[1], "--port", "0", "--device", "cpu",
         "--max-batch", "8", "--pad-batch", "3", "--warmup", "16x16,8x12"]))
    serve.close(srv)
    assert seen == [(n, h, w, 1) for h, w in ((16, 16), (8, 12)) for n in (3, 6, 9)]


def test_mesh_size_exits_naming_the_parallel_stack(ckpts, reference):
    """--mesh-size 2 serves: this process is space rank 0 and one gloo
    follower takes the other strip; a request within 1 LSB of the one-rank
    daemon's, /healthz names the mesh, and close() stops the follower."""
    srv = start(ckpts, "--mesh-size", "2")
    try:
        img = np.random.default_rng(3).integers(0, 256, (32, 24), dtype=np.uint8)
        status, _, out = post_png(srv.server_address[1], img)
        assert status == 200
        want = reference.predict(img[None, ..., None])[0]
        assert out.shape == want.shape
        assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
        assert get_json(srv.server_address[1], "/healthz")["mesh_size"] == 2
    finally:
        stop(srv)
    assert not srv.followers.alive()


def test_precision_scopes_of_two_threads_keep_tf32_off():
    """The backend flags are process-wide: a thread leaving its fp32 scope
    while another's is open must not turn TF32 back on under it."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    inside, leave_a, a_left = threading.Event(), threading.Event(), threading.Event()
    seen = []

    def a():
        with config.precision("fp32"):
            inside.set()
            leave_a.wait(TIMEOUT)
        a_left.set()

    t = threading.Thread(target=a)
    t.start()
    assert inside.wait(TIMEOUT)
    with config.precision("fp32"):
        leave_a.set()
        assert a_left.wait(TIMEOUT)
        seen.append(torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        with config.precision("tf32"):
            seen.append(torch.backends.cudnn.allow_tf32)
        seen.append(torch.backends.cudnn.allow_tf32)
    t.join(timeout=TIMEOUT)
    assert seen == [False, True, False]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
