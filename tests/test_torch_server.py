"""The port's serving daemon (roomnet_tpu_torch/infer/server.py) on the CPU:
health, labels, classify, error handling, admission, deadlines, streaming
and concurrency, each behaviour of tests/test_server.py (its mesh, orbax,
data-parallel and export cases aside), and the same PNG bytes through the
JAX package's ClassifierServer and the port's with the same weights:
class_id equal, probs within 1e-5. Hot reload, drain and shutdown are in
tests/test_torch_server_reload.py.

The classifiers run at tests/tiny.py's geometry on the CPU (`device="cpu"`,
the kernels' plain versions).
"""

import base64
import http.client
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from roomnet_tpu.infer.classify import RoomNetClassifier as JaxClassifier
from roomnet_tpu.infer.server import ClassifierServer as JaxServer
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.infer.server import ClassifierServer
from roomnet_tpu_torch.params import schema as tschema
from roomnet_tpu_torch.utils import profiling
from tests.tiny import TINY
from torch_port_util import LABELS4, get_json, img_bytes, post, tiny_classifier, url

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def server():
    # max_inflight=64: the burst test needs all 64 admitted (shedding has
    # its own tests with a small cap).
    srv = ClassifierServer(tiny_classifier(0, batch_size=4), port=0, max_inflight=64).start()
    yield srv
    srv.stop()


def _b64(body: bytes) -> str:
    return base64.b64encode(body).decode()


def test_same_png_bytes_answer_like_the_jax_server():
    """One PNG per request through both daemons, weights from
    init_variables(PRNGKey(0), TINY): class_id equal, probs within 1e-5."""
    jv = jax_init(jax.random.PRNGKey(0), TINY)
    flat = jschema.flatten_variables(jv)
    jsrv = JaxServer(JaxClassifier(jv, TINY, batch_size=4, class_labels=LABELS4), port=0).start()
    clf = tiny_classifier(0, batch_size=4)
    clf.variables = tschema.variables_from_numpy(flat, clf.cfg, "cpu")
    tsrv = ClassifierServer(clf, port=0).start()
    try:
        seen = set()
        for seed in range(8):
            body = img_bytes(seed, shape=(40 + seed, 50 + 3 * seed, 3))
            (js, jout), (ts, tout) = post(jsrv, "/classify", body), post(tsrv, "/classify", body)
            assert js == ts == 200
            assert tout["class_id"] == jout["class_id"] and tout["label"] == jout["label"]
            np.testing.assert_allclose(tout["probs"], jout["probs"], rtol=0, atol=1e-5)
            assert abs(tout["confidence"] - jout["confidence"]) <= 1e-5
            seen.add(tout["class_id"])
        payload = json.dumps({"images": [_b64(img_bytes(s)) for s in range(3)]}).encode()
        (js, jout), (ts, tout) = post(jsrv, "/classify_batch", payload), post(tsrv, "/classify_batch", payload)
        assert js == ts == 200
        for a, b in zip(tout["results"], jout["results"]):
            assert a["class_id"] == b["class_id"]
            np.testing.assert_allclose(a["probs"], b["probs"], rtol=0, atol=1e-5)
    finally:
        jsrv.stop()
        tsrv.stop()


def test_health_and_labels(server):
    assert get_json(server, "/healthz") == {"status": "ok"}
    assert get_json(server, "/labels") == LABELS4


def test_readyz_follows_worker_state():
    """/readyz: 200 while the device worker runs, 503 once it stops
    (/healthz keeps answering either way)."""
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False).start()
    try:
        assert get_json(srv, "/readyz")["status"] == "ready"
        srv._stop.set()  # the worker exits, HTTP stays up
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(url(srv, "/readyz"), timeout=10)
            except urllib.error.HTTPError as e:
                assert e.code == 503
                assert json.loads(e.read())["stopping"] is True
                break
            time.sleep(0.05)
        else:
            raise AssertionError("/readyz never flipped to 503")
        assert get_json(srv, "/healthz")["status"] == "ok"
    finally:
        srv.stop()


def test_start_fails_when_the_worker_cannot_start(monkeypatch):
    """A worker that cannot reach its device makes start() raise: /readyz
    never answers 200 for a server with no device."""
    srv = ClassifierServer(tiny_classifier(0), port=0)

    def broken():
        raise RuntimeError("no device")

    monkeypatch.setattr(srv, "_worker_start", broken)
    with pytest.raises(RuntimeError, match="did not start"):
        srv.start()
    srv.stop()


def test_classify_roundtrip(server):
    status, out = post(server, "/classify", img_bytes())
    assert status == 200
    assert out["label"] in LABELS4 and out["label"] == LABELS4[out["class_id"]]
    assert 0 < out["confidence"] <= 1 and out["confidence"] == out["probs"][out["class_id"]]
    assert len(out["probs"]) == 4 and abs(sum(out["probs"]) - 1) < 1e-4
    assert post(server, "/classify", img_bytes())[1] == out  # deterministic


def test_classify_bad_payload(server):
    status, out = post(server, "/classify", b"this is not an image")
    assert status == 400 and "error" in out


def test_oversized_body_rejected_413_before_read():
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False, max_body_bytes=1024).start()
    try:
        big = img_bytes()
        assert len(big) > 1024
        status, out = post(srv, "/classify", big)
        assert status == 413 and "too large" in out["error"]
        status, out = post(srv, "/classify_batch", json.dumps({"images": [_b64(big)]}).encode())
        assert status == 413 and "too large" in out["error"]
        small = cv2.imencode(".jpg", np.zeros((16, 16, 3), np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 50])[1]
        assert len(small.tobytes()) <= 1024
        status, out = post(srv, "/classify", small.tobytes())
        assert status == 200 and out["label"] in LABELS4
    finally:
        srv.stop()


def test_keepalive_connection_reuse(server):
    """Many requests over one TCP connection: a GET, classify POSTs and a
    drained-body POST to an unknown route, with correct framing."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        assert r.version == 11
        for _ in range(2):
            conn.request("POST", "/classify", body=img_bytes())
            r = conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["label"] in LABELS4
        conn.request("POST", "/nope", body=b"x" * 100)
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        conn.request("GET", "/labels")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read()) == LABELS4
    finally:
        conn.close()


def test_keepalive_socket_options(server):
    """TCP_NODELAY and a buffered wfile, as class attributes the stdlib
    handler honours on every accepted socket."""
    handler = server._httpd.RequestHandlerClass
    assert handler.disable_nagle_algorithm is True
    assert handler.wbufsize > 0


def test_idle_keepalive_connection_reaped():
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False, idle_connection_s=1.0).start()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        first = b""
        s.settimeout(2)
        while b'{"status": "ok"}' not in first:
            first += s.recv(4096)
        assert b"200" in first
        time.sleep(2.0)  # > idle_connection_s with no traffic
        s.settimeout(5)
        try:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            data = s.recv(4096)
        except (ConnectionResetError, BrokenPipeError):
            data = b""
        assert data == b"", f"expected reaped connection, got {data[:60]!r}"
        s.close()
    finally:
        srv.stop()


def test_oversized_and_chunked_close_the_connection():
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False, max_body_bytes=1024).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/classify", body=b"z" * 4096)
        r = conn.getresponse()
        assert r.status == 413 and r.headers.get("Connection", "").lower() == "close"
        r.read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.putrequest("POST", "/classify")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 411 and r.headers.get("Connection", "").lower() == "close"
        conn.close()
    finally:
        srv.stop()


def test_unknown_route(server):
    assert post(server, "/nope", b"")[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url(server, "/nope"), timeout=10)
    assert e.value.code == 404


def test_concurrent_requests_microbatch(server):
    results = {}

    def hit(i):
        results[i] = post(server, "/classify", img_bytes(seed=i))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 8 and all(status == 200 for status, _ in results.values())


def test_metrics_endpoint(server):
    post(server, "/classify", img_bytes())
    metrics = get_json(server, "/metrics")
    assert "serve/request" in metrics and "serve/device_call" in metrics and "serve/fetch" in metrics
    assert metrics["serve/device_call"]["count"] >= 1
    assert metrics["serve/request"]["mean_ms"] > 0


def test_metrics_report_measured_shipped_bytes(server):
    """Each device call counts the bytes it shipped, bucket padding
    included: a lone request rides the smallest bucket."""
    def stats():
        m = get_json(server, "/metrics")
        return (m.get("serve/device_call", {}).get("count", 0),
                m.get("serve/device_call_bytes", {}).get("total", 0))

    calls0, bytes0 = stats()
    assert post(server, "/classify", img_bytes())[0] == 200
    calls1, bytes1 = stats()
    n_calls = calls1 - calls0
    assert n_calls >= 1
    side = server.classifier.cfg.im_side
    assert bytes1 - bytes0 == n_calls * server._bucket_sizes[0] * side * side * 3


def test_failed_dispatch_ships_no_bytes():
    """serve/device_call_bytes counts only dispatched calls: a call that
    raises adds nothing, so bytes == calls * bucket bytes still holds."""
    clf = tiny_classifier(3, batch_size=2)
    real = clf._predict
    calls = {"n": 0}

    def flaky(variables, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated device failure")
        return real(variables, batch)

    clf._predict = flaky
    profiling.SPANS.reset()
    srv = ClassifierServer(clf, port=0).start()
    try:
        assert post(srv, "/classify", img_bytes())[0] == 503
        assert "serve/device_call_bytes" not in get_json(srv, "/metrics")
        assert post(srv, "/classify", img_bytes())[0] == 200
        side = clf.cfg.im_side
        assert get_json(srv, "/metrics")["serve/device_call_bytes"] == {"total": side * side * 3, "count": 1}
    finally:
        srv.stop()


def test_max_batch_larger_than_device_batch_is_clamped():
    srv = ClassifierServer(tiny_classifier(1, batch_size=2), port=0, max_batch=16).start()
    try:
        assert srv.max_batch == 2
        results = {}

        def hit(i):
            results[i] = post(srv, "/classify", img_bytes(seed=i))

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 7 and all(status == 200 for status, _ in results.values())
    finally:
        srv.stop()


def test_burst_of_64_concurrent_requests_all_succeed(server):
    """The listen backlog holds a 64-way burst (the stdlib's 5 refused it)."""
    results = {}

    def hit(i):
        try:
            results[i] = post(server, "/classify", img_bytes(seed=i % 4))
        except Exception as e:  # connection refused/reset
            results[i] = ("EXC", repr(e))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    failures = {i: r for i, r in results.items() if r[0] != 200}
    assert len(results) == 64 and not failures, f"{len(failures)} failed: {list(failures.values())[:3]}"


def test_device_failure_returns_503_and_recovers():
    clf = tiny_classifier(3, batch_size=2)
    real = clf._predict
    calls = {"n": 0}

    def flaky(variables, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated device session failure")
        return real(variables, batch)

    clf._predict = flaky
    srv = ClassifierServer(clf, port=0).start()
    try:
        status, out = post(srv, "/classify", img_bytes())
        assert status == 503 and "device_error" in out["error"]
        status2, out2 = post(srv, "/classify", img_bytes())
        assert status2 == 200 and out2["label"] in LABELS4
    finally:
        srv.stop()


def test_classify_batch_one_device_call(server):
    before = get_json(server, "/metrics").get("serve/device_call", {}).get("count", 0)
    payload = json.dumps({"images": [_b64(img_bytes(seed=1)), _b64(b"junk not an image"),
                                     _b64(img_bytes(seed=2))]}).encode()
    status, out = post(server, "/classify_batch", payload)
    assert status == 200
    rs = out["results"]
    assert len(rs) == 3 and rs[0]["label"] in LABELS4 and rs[2]["label"] in LABELS4
    assert rs[1] == {"error": "undecodable image"}
    assert get_json(server, "/metrics")["serve/device_call"]["count"] == before + 1


def test_classify_batch_bad_payload(server):
    assert post(server, "/classify_batch", b"{not json")[0] == 400
    assert post(server, "/classify_batch", json.dumps({"images": "x"}).encode())[0] == 400
    status, out = post(server, "/classify_batch", json.dumps({"images": []}).encode())
    assert status == 200 and out["results"] == []
    # base64 of nothing, and an empty body: undecodable, never a dropped connection
    status, out = post(server, "/classify_batch", json.dumps({"images": ["%%%"]}).encode())
    assert status == 200 and out["results"] == [{"error": "undecodable image"}]
    assert post(server, "/classify", b"")[0] == 400
    too_many = json.dumps({"images": [_b64(img_bytes())] * (server.max_inflight + 1)}).encode()
    assert post(server, "/classify_batch", too_many)[0] == 413


def test_sustained_overload_sheds_fast_with_429():
    """Over twice the capacity, sustained: fast 429s with Retry-After and
    bounded latency for what is admitted, no 504 pile-up."""
    clf = tiny_classifier(5, batch_size=2)
    real = clf._predict

    def slow(variables, batch):  # ~20 img/s device capacity
        time.sleep(0.1)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, max_inflight=4, request_timeout_s=10.0).start()
    statuses, latencies, errors = [], [], []
    lock = threading.Lock()
    stop_at = time.monotonic() + 6.0
    body = img_bytes()

    def client():
        while time.monotonic() < stop_at:
            t0 = time.monotonic()
            try:
                status, _ = post(srv, "/classify", body)
            except Exception as e:
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                statuses.append(status)
                latencies.append(time.monotonic() - t0)

    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        srv.stop()
    assert not errors, errors[:3]
    counts = {s: statuses.count(s) for s in set(statuses)}
    assert set(counts) <= {200, 429}, counts
    assert counts.get(200, 0) > 0 and counts.get(429, 0) > 0, counts
    assert max(latencies) < 5.0, max(latencies)


def test_device_calls_use_bucketed_batch_shapes():
    """A lone request ships a batch of 1, three rows a bucket of 4, not the
    full batch of 8."""
    clf = tiny_classifier(7, batch_size=8)
    real = clf._predict
    shapes = []

    def spy(variables, batch):
        shapes.append(batch.shape[0])
        return real(variables, batch)

    clf._predict = spy
    srv = ClassifierServer(clf, port=0).start()
    try:
        assert srv._bucket_sizes == [1, 2, 4, 8]
        assert post(srv, "/classify", img_bytes())[0] == 200
        assert shapes[-1] == 1, shapes
        payload = json.dumps({"images": [_b64(img_bytes(seed=s)) for s in range(3)]}).encode()
        assert post(srv, "/classify_batch", payload)[0] == 200
        assert shapes[-1] == 4, shapes
    finally:
        srv.stop()


def test_abandoned_jobs_never_reach_the_device():
    clf = tiny_classifier(9, batch_size=1)
    real = clf._predict
    calls = []

    def slow(variables, batch):
        calls.append(batch.shape[0])
        time.sleep(1.2)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, request_timeout_s=0.3).start()
    try:
        statuses = []
        lock = threading.Lock()

        def hit():
            s, _ = post(srv, "/classify", img_bytes())
            with lock:
                statuses.append(s)

        threads = [threading.Thread(target=hit) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert statuses == [504, 504, 504, 504], statuses
        time.sleep(3.0)  # let the worker drain whatever it will
        assert len(calls) <= 2, calls
    finally:
        srv.stop()


def test_budget_expires_mid_queue():
    """X-Timeout-Seconds: a job queued behind a slow device call answers 504
    within about its budget of arrival and never reaches the device."""
    clf = tiny_classifier(13, batch_size=1)
    real = clf._predict
    calls = []

    def slow(variables, batch):
        calls.append(batch.shape[0])
        time.sleep(1.0)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, request_timeout_s=10.0).start()
    try:
        out = {}
        t1 = threading.Thread(target=lambda: out.update(first=post(srv, "/classify", img_bytes())))
        t1.start()
        time.sleep(0.3)  # the first request is on the device now
        t0 = time.monotonic()
        status, body = post(srv, "/classify", img_bytes(seed=1), {"X-Timeout-Seconds": "0.4"})
        waited = time.monotonic() - t0
        t1.join(timeout=30)
        assert status == 504, (status, body)
        assert waited < 2.0, waited
        assert out["first"][0] == 200
        time.sleep(1.5)
        assert len(calls) == 1, calls
    finally:
        srv.stop()


def test_budget_header_clamped_to_server_cap():
    srv = ClassifierServer(tiny_classifier(15, batch_size=2), port=0, request_timeout_s=10.0).start()
    try:
        for raw in ("9999", "nonsense"):
            status, out = post(srv, "/classify", img_bytes(), {"X-Timeout-Seconds": raw})
            assert status == 200 and out["label"] in LABELS4
    finally:
        srv.stop()


def test_classify_batch_stream_ndjson(server):
    payload = json.dumps({"images": [_b64(img_bytes(seed=1)), _b64(b"junk not an image"),
                                     _b64(img_bytes(seed=2))]}).encode()
    req = urllib.request.Request(url(server, "/classify_batch?stream=1"), data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(l) for l in r.read().splitlines()]
    assert [l["index"] for l in lines] == [0, 1, 2]
    assert lines[0]["label"] in LABELS4 and lines[2]["label"] in LABELS4
    assert lines[1]["error"] == "undecodable image"
    status, out = post(server, "/classify_batch", payload)
    assert status == 200
    assert out["results"][0]["label"] == lines[0]["label"]
    assert out["results"][2]["probs"] == lines[2]["probs"]
    # an empty stream is still a stream
    req = urllib.request.Request(url(server, "/classify_batch?stream=1"),
                                 data=json.dumps({"images": []}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and r.read() == b""


def test_classify_batch_stream_first_results_early():
    """With a device whose cost lands at the fetch, the first chunk's lines
    arrive after one device call, not after the whole batch."""
    clf = tiny_classifier(17, batch_size=2)
    real = clf._predict

    class SlowFetch:
        def __init__(self, val):
            self.val = np.asarray(val)

        def __array__(self, dtype=None, copy=None):
            time.sleep(0.5)
            return self.val if dtype is None else self.val.astype(dtype)

    def slow(variables, batch):
        ids, probs = real(variables, batch)
        return SlowFetch(ids), probs

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, max_inflight=64).start()
    try:
        payload = json.dumps({"images": [_b64(img_bytes(seed=s)) for s in range(6)]}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        t0 = time.monotonic()
        conn.request("POST", "/classify_batch?stream=1", body=payload)
        resp = conn.getresponse()
        first_line = resp.fp.readline()
        t_first = time.monotonic() - t0
        rest = resp.read()
        t_all = time.monotonic() - t0
        conn.close()
        assert json.loads(first_line)["index"] == 0
        assert len(rest.splitlines()) == 5
        assert t_all >= 1.2, t_all
        assert t_first <= t_all - 0.7, (t_first, t_all)
    finally:
        srv.stop()


def test_classify_batch_stream_device_error_mid_stream():
    clf = tiny_classifier(21, batch_size=2)
    real = clf._predict
    calls = {"n": 0}

    def flaky(variables, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device failure")
        return real(variables, batch)

    clf._predict = flaky
    srv = ClassifierServer(clf, port=0, max_inflight=64).start()
    try:
        payload = json.dumps({"images": [_b64(img_bytes(seed=s)) for s in range(4)]}).encode()
        req = urllib.request.Request(url(srv, "/classify_batch?stream=1"), data=payload, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            lines = [json.loads(l) for l in r.read().splitlines()]
        assert len(lines) == 4
        assert lines[0]["label"] in LABELS4 and lines[1]["label"] in LABELS4
        assert "device_error" in lines[2]["error"] and "device_error" in lines[3]["error"]
        status, out = post(srv, "/classify", img_bytes())
        assert status == 200 and out["label"] in LABELS4
    finally:
        srv.stop()


def _client_module():
    sys.path.insert(0, REPO)
    from tools import classify_client

    return classify_client


def test_reference_client_against_live_server(tmp_path):
    """tools/classify_client.py, the documented way to consume the API,
    against the port's daemon: batch and streaming agree, an undecodable
    file fails per row, one keep-alive connection serves many calls."""
    cc = _client_module()
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False).start()
    try:
        paths = []
        for i in range(5):
            p = tmp_path / f"im_{i}.png"
            p.write_bytes(img_bytes(seed=i))
            paths.append(str(p))
        bad = tmp_path / "corrupt.jpg"
        bad.write_text("not an image")
        paths.append(str(bad))
        base = f"http://127.0.0.1:{srv.port}"
        plain = cc.classify_paths(base, paths, batch=4)
        streamed = cc.classify_paths(base, paths, stream=True, batch=4)
        assert set(plain) == set(streamed) == set(paths)
        for p in paths[:-1]:
            assert plain[p]["label"] in LABELS4 and streamed[p]["label"] == plain[p]["label"]
        assert "error" in plain[str(bad)] and "error" in streamed[str(bad)]
        cl = cc.Client(base)
        try:
            assert cl.classify_bytes(img_bytes(seed=0))["label"] == plain[paths[0]]["label"]
            assert cl.classify_bytes(img_bytes(seed=1))["label"] == plain[paths[1]]["label"]
        finally:
            cl.close()
    finally:
        srv.stop()


def test_reference_client_budget_propagates_as_504():
    cc = _client_module()
    clf = tiny_classifier(0, batch_size=2)
    real = clf._predict

    def slow(variables, batch):
        time.sleep(1.5)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, request_timeout_s=30.0).start()
    cl = cc.Client(f"http://127.0.0.1:{srv.port}", budget_s=0.3)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="504"):
            cl.classify_bytes(img_bytes())
        assert time.monotonic() - t0 < 5.0
    finally:
        cl.close()
        srv.stop()


def test_access_log_records_every_answered_request(tmp_path):
    log_path = str(tmp_path / "access.jsonl")
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False, access_log=log_path).start()
    try:
        assert post(srv, "/classify", img_bytes())[0] == 200
        assert post(srv, "/classify", b"junk")[0] == 400
        assert post(srv, "/nope", b"")[0] == 404
        req = urllib.request.Request(url(srv, "/classify_batch?stream=1"),
                                     data=json.dumps({"images": []}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        get_json(srv, "/healthz")
    finally:
        srv.stop()
    with open(log_path) as f:
        recs = [json.loads(l) for l in f]
    by_path = {(r["method"], r["path"], r["status"]) for r in recs}
    assert {("POST", "/classify", 200), ("POST", "/classify", 400), ("POST", "/nope", 404),
            ("GET", "/healthz", 200), ("POST", "/classify_batch", 200)} <= by_path
    assert all(r["kind"] == "request" for r in recs)
    assert all(r["ms"] is None or 0 <= r["ms"] < 60_000 for r in recs)


def test_access_log_failure_never_breaks_serving(tmp_path):
    srv = ClassifierServer(tiny_classifier(0), port=0, warmup=False,
                           access_log=str(tmp_path / "no_such_dir" / "access.jsonl")).start()
    try:
        st, out = post(srv, "/classify", img_bytes())
        assert st == 200 and out["label"] in LABELS4
        assert srv._access_log.path is None  # disabled after the first failure
        assert post(srv, "/classify", img_bytes())[0] == 200
    finally:
        srv.stop()


def test_malformed_content_length_answers_400(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.putrequest("POST", "/classify")
        conn.putheader("Content-Length", "not-a-number")
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 400 and r.headers.get("Connection", "").lower() == "close"
    finally:
        conn.close()
