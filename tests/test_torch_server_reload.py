"""The port's serving daemon on the CPU, continued: hot reload (the
structural gate, the probe forward, auto-reload, serialized reloads, a
swap under live traffic), graceful drain, shutdown, warmup, and the worker
surviving a result-assembly error, each behaviour of tests/test_server.py;
reload answers against the JAX package's CheckpointStore files; a model dir
of the JAX package's orbax checkpoints answers 409, and one of the port's
DCP checkpoints reloads. tests/test_torch_server.py has the rest.
"""

import base64
import http.client
import json
import logging
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from chip_smoke import tiny_config
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params.checkpoint import CheckpointStore as JaxStore
from roomnet_tpu_torch.infer.server import ClassifierServer
from roomnet_tpu_torch.models.roomnet import init_variables
from roomnet_tpu_torch.params import schema
from roomnet_tpu_torch.params.checkpoint import CheckpointStore
from tests.tiny import TINY
from torch_port_util import LABELS4, get_json, img_bytes, post, tiny_classifier, url

pytest.importorskip("cv2")


def _variables(seed, cfg=None):
    return init_variables(torch.Generator().manual_seed(seed), cfg or tiny_config())


def _wait_for_step(srv, step, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if get_json(srv, "/version")["step"] == step:
            return True
        time.sleep(0.05)
    return False


def test_hot_reload_swaps_weights_without_restart(tmp_path):
    """POST /reload: 404 on an empty dir; a new checkpoint swaps in (the
    answers change, /version bumps); a checkpoint of another num_classes is
    rejected with 409 and the old weights keep serving."""
    import dataclasses

    clf = tiny_classifier(23, batch_size=2)
    mdir = str(tmp_path / "models")
    store = CheckpointStore(mdir)
    srv = ClassifierServer(clf, port=0, model_dir=mdir).start()
    try:
        body = img_bytes(seed=9)
        st, out = post(srv, "/reload", b"")
        assert st == 404, out
        st, before = post(srv, "/classify", body)
        assert st == 200
        store.save(_variables(99), 7, suffix="0.9")
        st, out = post(srv, "/reload", b"")
        assert st == 200 and out == {"status": "reloaded", "step": 7}, out
        assert get_json(srv, "/version") == {"step": 7, "path": mdir}
        st, after = post(srv, "/classify", body)
        assert st == 200 and before["probs"] != after["probs"]
        bad = _variables(1, dataclasses.replace(tiny_config(), num_classes=3))
        store.save(bad, 9, suffix="bad")
        st, out = post(srv, "/reload", b"")
        assert st == 409 and "shape" in out["error"], out
        st, still = post(srv, "/classify", body)
        assert st == 200 and still["probs"] == after["probs"]
        assert get_json(srv, "/version")["step"] == 7
    finally:
        srv.stop()


def test_reload_of_a_jax_checkpoint_serves_its_weights(tmp_path):
    """A checkpoint the JAX package's store wrote (init_variables(PRNGKey(5),
    TINY), with opt state) reloads into the port's daemon, which then
    answers as a classifier built on those weights does."""
    jv = jax_init(jax.random.PRNGKey(5), TINY)
    mdir = str(tmp_path / "models")
    JaxStore(mdir).save(jv, 11, suffix="0.7", opt_state_flat={"count": np.asarray(3)})
    clf = tiny_classifier(0, batch_size=2)
    srv = ClassifierServer(clf, port=0, model_dir=mdir).start()
    try:
        st, out = post(srv, "/reload", b"")
        assert st == 200 and out["step"] == 11
        ref = tiny_classifier(0, batch_size=2)
        from roomnet_tpu.params import schema as jschema

        ref.variables = schema.variables_from_numpy(jschema.flatten_variables(jv), ref.cfg, "cpu")
        for seed in range(3):
            body = img_bytes(seed=seed)
            st, served = post(srv, "/classify", body)
            import cv2

            im = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
            ids, probs = ref.predict(ref.prep_decoded(im)[None])
            assert st == 200 and served["class_id"] == int(ids[0])
            np.testing.assert_allclose(served["probs"], probs[0], rtol=0, atol=1e-6)
    finally:
        srv.stop()


def test_reload_moves_every_argmax_with_a_rolled_head(tmp_path):
    """The rolled-head tree (the last dense layer's kernel columns and bias
    rolled by one class) is an exact logit permutation: after /reload every
    answer's class moves by one."""
    clf = tiny_classifier(31, batch_size=4)
    # A bias that keeps every logit above ReLU6's floor: no ties at 0.
    flat_base = schema.flatten_variables(clf.variables)
    flat_base["dense/2/bias"] = flat_base["dense/2/bias"] + 1.0 + np.arange(4, dtype=np.float32) * 0.01
    clf.variables = schema.variables_from_numpy(flat_base, clf.cfg, "cpu")
    flat = dict(flat_base)
    flat["dense/2/kernel"] = np.roll(flat["dense/2/kernel"], 1, axis=1)
    flat["dense/2/bias"] = np.roll(flat["dense/2/bias"], 1)
    mdir = str(tmp_path / "models")
    CheckpointStore(mdir).save(schema.variables_from_numpy(flat, clf.cfg, "cpu"), 2)
    srv = ClassifierServer(clf, port=0, model_dir=mdir).start()
    try:
        bodies = [img_bytes(seed=s) for s in range(6)]
        before = [post(srv, "/classify", b)[1]["class_id"] for b in bodies]
        assert post(srv, "/reload", b"")[0] == 200
        after = [post(srv, "/classify", b)[1]["class_id"] for b in bodies]
        assert after == [(c + 1) % 4 for c in before]
    finally:
        srv.stop()


def test_auto_reload_picks_up_new_checkpoints(tmp_path):
    import dataclasses

    clf = tiny_classifier(23, batch_size=2)
    mdir = str(tmp_path / "models")
    store = CheckpointStore(mdir)
    with pytest.raises(ValueError):
        ClassifierServer(clf, port=0, auto_reload_s=0.05)  # needs model_dir
    srv = ClassifierServer(clf, port=0, model_dir=mdir, auto_reload_s=0.05).start()
    try:
        body = img_bytes(seed=9)
        st, before = post(srv, "/classify", body)
        assert st == 200 and get_json(srv, "/version")["step"] is None
        store.save(_variables(99), 7, suffix="0.9")
        assert _wait_for_step(srv, 7), "auto-reload never picked up step 7"
        st, after = post(srv, "/classify", body)
        assert st == 200 and before["probs"] != after["probs"]
        store.save(_variables(1, dataclasses.replace(tiny_config(), num_classes=3)), 9, suffix="bad")
        time.sleep(0.5)
        assert get_json(srv, "/version")["step"] == 7
        st, still = post(srv, "/classify", body)
        assert st == 200 and still["probs"] == after["probs"]
    finally:
        srv.stop()


def test_auto_reload_survives_poll_failure(tmp_path):
    clf = tiny_classifier(23, batch_size=2)
    mdir = str(tmp_path / "models")
    store = CheckpointStore(mdir)
    srv = ClassifierServer(clf, port=0, model_dir=mdir, auto_reload_s=0.05)
    real_open, fails = srv._open_store, {"n": 0}

    def flaky_open():
        if fails["n"] < 3:
            fails["n"] += 1
            raise OSError("transient poll failure")
        return real_open()

    srv._open_store = flaky_open
    records = []

    class _Collect(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    collector = _Collect()
    logging.getLogger("roomnet_tpu_torch.server").addHandler(collector)
    srv.start()
    try:
        store.save(_variables(99), 7, suffix="0.9")
        assert _wait_for_step(srv, 7), f"auto-reload died on a poll failure ({fails['n']} injected)"
        assert fails["n"] == 3
        polls = [m for m in records if "poll failed" in m]
        assert len(polls) == 1, polls  # identical failures warn once
    finally:
        logging.getLogger("roomnet_tpu_torch.server").removeHandler(collector)
        srv.stop()


def test_orbax_model_dir_answers_409(tmp_path):
    """A model dir of the JAX package's orbax checkpoint directories: /reload
    answers 409 naming the directory and the weights stay. One of the port's
    DCP checkpoint directories (params/orbax_io.py) reloads: 200, its step."""
    from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore

    mdir = tmp_path / "models_orbax"
    (mdir / "roomnet--0.8--12").mkdir(parents=True)
    (mdir / "roomnet--0.8--12" / "_CHECKPOINT_METADATA").write_text("{}")
    srv = ClassifierServer(tiny_classifier(23, batch_size=2), port=0, model_dir=str(mdir)).start()
    try:
        st, out = post(srv, "/reload", b"")
        assert st == 409 and "roomnet--0.8--12" in out["error"] and "JAX package's orbax" in out["error"], out
        assert get_json(srv, "/version")["step"] is None
        assert post(srv, "/classify", img_bytes())[0] == 200
    finally:
        srv.stop()
    ddir = tmp_path / "models_dcp"
    OrbaxCheckpointStore(str(ddir), async_save=False).save(_variables(5), 14, suffix="0.7")
    srv = ClassifierServer(tiny_classifier(23, batch_size=2), port=0, model_dir=str(ddir)).start()
    try:
        st, out = post(srv, "/reload", b"")
        assert st == 200, out
        assert get_json(srv, "/version")["step"] == 14
        assert post(srv, "/classify", img_bytes())[0] == 200
    finally:
        srv.stop()


def test_hot_reload_during_live_traffic(tmp_path):
    """/reload racing a request burst: every request answers 200 and the
    daemon ends on the new version."""
    clf = tiny_classifier(29, batch_size=4)
    mdir = str(tmp_path / "models")
    CheckpointStore(mdir).save(_variables(31), 5)
    srv = ClassifierServer(clf, port=0, max_inflight=64, model_dir=mdir).start()
    try:
        statuses = []
        lock = threading.Lock()

        def hit(i):
            s, _ = post(srv, "/classify", img_bytes(seed=i % 4))
            with lock:
                statuses.append(s)

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        st, out = post(srv, "/reload", b"")
        assert st == 200 and out["step"] == 5
        for t in threads:
            t.join(timeout=30)
        assert len(statuses) == 24 and all(s == 200 for s in statuses), statuses
    finally:
        srv.stop()


def test_reload_disabled_without_model_dir():
    srv = ClassifierServer(tiny_classifier(0), port=0).start()
    try:
        st, out = post(srv, "/reload", b"")
        assert st == 403 and "disabled" in out["error"]
    finally:
        srv.stop()


def test_warmup_runs_every_bucket_before_serving():
    clf = tiny_classifier(2, batch_size=8)
    real = clf._predict
    shapes = []

    def spy(variables, batch):
        shapes.append(batch.shape[0])
        return real(variables, batch)

    clf._predict = spy
    srv = ClassifierServer(clf, port=0, warmup=True).start()
    try:
        assert shapes == [1, 2, 4, 8]
        status, out = post(srv, "/classify", img_bytes())
        assert status == 200 and out["label"] in LABELS4
    finally:
        srv.stop()


def test_reload_corrupt_checkpoint_file_rejected(tmp_path):
    clf = tiny_classifier(41, batch_size=2)
    mdir = tmp_path / "models"
    CheckpointStore(str(mdir)).save(_variables(42), 5)
    srv = ClassifierServer(clf, port=0, model_dir=str(mdir)).start()
    try:
        st, out = post(srv, "/reload", b"")
        assert st == 200 and out["step"] == 5
        (mdir / "roomnet--0.9--9.npz").write_bytes(b"not a zipfile")
        st, out = post(srv, "/reload", b"")
        assert st == 409 and "rejected" in out["error"], out
        assert get_json(srv, "/version")["step"] == 5
        assert post(srv, "/classify", img_bytes())[0] == 200
    finally:
        srv.stop()


def test_reload_probe_rejects_nonfinite_weights(tmp_path):
    clf = tiny_classifier(43, batch_size=2)
    mdir = str(tmp_path / "models")
    flat = schema.flatten_variables(_variables(44))
    flat["dense/0/kernel"] = np.full_like(flat["dense/0/kernel"], np.nan)
    CheckpointStore(mdir).save(schema.variables_from_numpy(flat, clf.cfg, "cpu"), 7, suffix="nan")
    srv = ClassifierServer(clf, port=0, model_dir=mdir).start()
    try:
        body = img_bytes(seed=3)
        st, before = post(srv, "/classify", body)
        assert st == 200
        st, out = post(srv, "/reload", b"")
        assert st == 409 and "non-finite" in out["error"], out
        st, still = post(srv, "/classify", body)
        assert st == 200 and still["probs"] == before["probs"]
    finally:
        srv.stop()


def test_worker_survives_result_assembly_error():
    clf = tiny_classifier(45, batch_size=2)
    srv = ClassifierServer(clf, port=0).start()
    try:
        clf.class_labels = []  # IndexError on any predicted class id
        st, out = post(srv, "/classify", img_bytes(seed=5))
        assert st == 503 and "inference backend" in out["error"], out
        clf.class_labels = list(LABELS4)
        st, out = post(srv, "/classify", img_bytes(seed=5))
        assert st == 200 and out["label"] in LABELS4, out
    finally:
        srv.stop()


def test_concurrent_reloads_serialize(tmp_path):
    clf = tiny_classifier(50, batch_size=2)
    mdir = str(tmp_path / "models")
    store = CheckpointStore(mdir)
    store.save(_variables(51), 10)
    newest = _variables(52)
    store.save(newest, 20)
    srv = ClassifierServer(clf, port=0, model_dir=mdir).start()
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(lambda _: post(srv, "/reload", b""), range(4)))
        assert all(st == 200 and out["step"] == 20 for st, out in outs), outs
        assert get_json(srv, "/version")["step"] == 20
        want, got = schema.flatten_variables(newest), schema.flatten_variables(clf.variables)
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    finally:
        srv.stop()


def test_server_matches_predict_paths_on_same_bytes(tmp_path, monkeypatch):
    """HTTP /classify and predict_paths through cv2 share one host
    preprocess (prep_decoded): the same bytes give the same class and
    confidence. (The native decoder's resize rounds up to one gray level
    apart from cv2's, in both packages, so it is switched off here.)"""
    from roomnet_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    clf = tiny_classifier(47, batch_size=2)
    body = img_bytes(seed=11)
    p = tmp_path / "img.png"
    p.write_bytes(body)
    ids, confs, ok = clf.predict_paths([str(p)])
    assert ok[0]
    srv = ClassifierServer(clf, port=0).start()
    try:
        st, out = post(srv, "/classify", body)
        assert st == 200 and out["class_id"] == int(ids[0])
        assert abs(out["confidence"] - float(confs[0][int(ids[0])])) < 1e-6
    finally:
        srv.stop()


def test_graceful_drain_finishes_inflight_and_sheds_new():
    clf = tiny_classifier(6, batch_size=2)
    real = clf._predict
    release = threading.Event()

    def gated(variables, batch):
        release.wait(timeout=30)
        return real(variables, batch)

    clf._predict = gated
    srv = ClassifierServer(clf, port=0, request_timeout_s=30.0).start()
    try:
        inflight_out = {}
        t = threading.Thread(target=lambda: inflight_out.update(resp=post(srv, "/classify", img_bytes())))
        t.start()
        deadline = time.monotonic() + 10
        while srv._inflight == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._inflight == 1
        srv.begin_drain()
        st, out = post(srv, "/classify", img_bytes())
        assert st == 503 and "draining" in out["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url(srv, "/readyz"), timeout=10)
        assert e.value.code == 503
        payload = json.loads(e.value.read())
        assert payload["status"] == "draining" and payload["inflight"] == 1
        assert get_json(srv, "/healthz")["status"] == "ok"
        assert not srv.wait_drained(0.3)
        release.set()
        assert srv.wait_drained(10.0), "in-flight request never finished"
        t.join(timeout=10)
        st, out = inflight_out["resp"]
        assert st == 200 and out["label"] in LABELS4
    finally:
        release.set()
        srv.stop()


def test_drain_lets_admitted_stream_finish():
    clf = tiny_classifier(8, batch_size=2)
    real = clf._predict

    def slow(variables, batch):
        time.sleep(0.5)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, request_timeout_s=30.0).start()
    try:
        payload = json.dumps({"images": [base64.b64encode(img_bytes(seed=i)).decode()
                                         for i in range(8)]}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/classify_batch?stream=1", body=payload)
        r = conn.getresponse()
        assert r.status == 200
        first = r.readline()
        assert json.loads(first)["index"] == 0
        srv.begin_drain()
        lines = [first] + [ln for ln in r.read().splitlines() if ln.strip()]
        assert len(lines) == 8, lines
        assert all(json.loads(ln).get("label") in LABELS4 for ln in lines)
        conn.close()
        assert srv.wait_drained(10.0)
    finally:
        srv.stop()


def test_drain_waits_for_request_still_reading_its_body():
    srv = ClassifierServer(tiny_classifier(9, batch_size=2), port=0).start()
    try:
        body = img_bytes()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        sock.sendall(b"POST /classify HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n" % len(body))
        sock.sendall(body[:10])
        deadline = time.monotonic() + 10
        while srv._active_requests == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._active_requests == 1
        srv.begin_drain()
        assert not srv.wait_drained(0.3), "drained while a request body was still arriving"
        sock.sendall(body[10:])
        assert srv.wait_drained(10.0)
        resp = sock.recv(65536).decode()
        assert resp.startswith("HTTP/1.1 200"), resp[:100]
        sock.close()
    finally:
        srv.stop()


def test_serve_forever_sigterm_clean_shutdown():
    srv = ClassifierServer(tiny_classifier(0, batch_size=2), port=0, warmup=False)
    prev = signal.getsignal(signal.SIGTERM)
    threading.Timer(0.5, lambda: os.kill(os.getpid(), signal.SIGTERM)).start()
    t0 = time.monotonic()
    srv.serve_forever()  # blocks the main thread until the signal
    assert time.monotonic() - t0 < 10
    assert srv._stop.is_set()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_stop_fails_queued_jobs_fast():
    clf = tiny_classifier(19, batch_size=1)
    real = clf._predict

    def slow(variables, batch):
        time.sleep(1.0)
        return real(variables, batch)

    clf._predict = slow
    srv = ClassifierServer(clf, port=0, request_timeout_s=30.0).start()
    statuses = []
    lock = threading.Lock()

    def hit():
        t0 = time.monotonic()
        try:
            s, _ = post(srv, "/classify", img_bytes())
        except Exception:
            s = "EXC"
        with lock:
            statuses.append((s, time.monotonic() - t0))

    threads = [threading.Thread(target=hit) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    srv.stop()
    for t in threads:
        t.join(timeout=10)
    assert len(statuses) == 3, statuses
    assert all(dt < 5.0 for _, dt in statuses), statuses
