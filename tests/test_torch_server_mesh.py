"""The port's serving daemon on a mesh (roomnet_tpu_torch/infer/server.py:
lockstep ranks, rank 0 serving HTTP) on the CPU: two ranks over gloo
(tests/torch_dp_worker.py:mesh_server, which runs chip_smoke.mesh_serve on
each rank) at tests/tiny.py's geometry, batch 8, labels A-D.

The counterparts of tests/test_server.py's
`test_mesh_backed_server_buckets_stay_shardable` (buckets start at the data
axis: [2, 4, 8] on two ranks) and `test_reload_on_mesh_backed_classifier`
(both ranks serve step 12 after /reload, and answer as a fresh
single-process JAX classifier on the new tree). The same PNG bytes (one
/classify, a 5-image /classify_batch and a 20-image ?stream=1, chip_smoke.
mesh_requests) go through the mesh and through the JAX ClassifierServer
over RoomNetClassifier on `make_mesh(8, 1)`: class_id equal, probabilities
within TOL = 1e-5 (tests/test_torch_server.py's tolerance). A NaN tree
answers 409 and every rank keeps the old tree; SIGTERM (drain 2 s) ends
every rank with 0; a follower that dies makes rank 0 answer 503 and end
within the group's timeout; a world of one answers as no mesh, bit for
bit. A reload that one rank cannot load is refused on every rank, with no
probe; an idle rank 0 sends heartbeat headers. Planted faults
(torch_dp_worker.FAULTS: buckets from 1, a reload that swaps rank 0 alone)
fail the checks.

The two-rank runs happen once per module: `ranks` (the served run and the
faulted ones, in one process pair) and `lost_follower`.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

from chip_smoke import answers_gap, classify_requests, mesh_requests, tiny_config
from roomnet_tpu.infer.classify import RoomNetClassifier as JaxClassifier
from roomnet_tpu.infer.server import ClassifierServer as JaxServer
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.infer.classify import RoomNetClassifier
from roomnet_tpu_torch.infer.server import ClassifierServer
from roomnet_tpu_torch.parallel import distributed
from roomnet_tpu_torch.parallel.mesh import make_mesh
from roomnet_tpu_torch.params import schema as tschema
from tests import torch_dp_worker as W
from tests.tiny import TINY
from torch_port_util import LABELS4

pytest.importorskip("cv2")
TOL = 1e-5
STEP, NAN_STEP = 12, 13
BATCH = 8


def _flat(seed: int) -> dict:
    """init_variables(PRNGKey(seed), TINY) with random BN statistics."""
    rng = np.random.RandomState(seed)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(seed), TINY))
    for k in flat:
        if "bn/" in k:
            n, field = flat[k].shape, k.rsplit("/", 1)[1]
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1,
                       "mean": rng.randn(*n) * 0.1, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    return flat


FLAT, SECOND = _flat(0), _flat(1)
NAN = dict(FLAT, **{"dense/0/kernel": np.full_like(FLAT["dense/0/kernel"], np.nan)})
REQUESTS = mesh_requests(seed=3, n_batch=5, n_stream=20)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = {"serve": {"reloads": [(STEP, SECOND), (NAN_STEP, NAN)]},
            "rank1_cannot_load": {"reloads": [(STEP, SECOND)], "own_dirs": True},
            "bucket_base_1": {"fault": "bucket_base_1"},
            "reload_rank0_only": {"fault": "reload_rank0_only", "reloads": [(STEP, SECOND)]}}
    return W.spawn("mesh_server", 2, tmp_path_factory.mktemp("mesh_server"), flat=FLAT, requests=REQUESTS,
                   runs=runs)


@pytest.fixture(scope="module")
def lost_follower(tmp_path_factory):
    """Rank 1 exits at its first device call after the warmup's three."""
    return W.spawn("mesh_server", 2, tmp_path_factory.mktemp("mesh_lost"), flat=FLAT, requests=REQUESTS,
                   runs={"serve": {}}, kill_after=3)


def _jax_answers(flat: dict, mesh) -> dict:
    clf = JaxClassifier(jschema.unflatten_variables(flat, TINY), TINY, batch_size=BATCH, class_labels=LABELS4,
                        mesh=mesh)
    srv = JaxServer(clf, port=0).start()
    try:
        return classify_requests(srv.port, REQUESTS)
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX server's answers: the mesh classifier on the first tree, a
    fresh single-process one on the second."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return {"first": _jax_answers(FLAT, jax_make_mesh(8, 1)), "second": _jax_answers(SECOND, None)}


def check_buckets(r0: dict, r1: dict):
    """Buckets from the data axis; both ranks make the same calls; the lone
    /classify (the first call after the warmup's three) pads to 2."""
    assert r0["buckets"] == [2, 4, 8]
    assert r0["sizes"] == r1["sizes"]
    assert r0["sizes"][:4] == [2, 4, 8, 2]


def check_reload(r0: dict, r1: dict, want: dict):
    """/reload of the second tree: 200 at step 12, every rank serving it, and
    the answers after it within TOL of `want`."""
    good = r0["client"]["reloads"][0]
    assert good["status"] == 200 and good["reply"] == {"status": "reloaded", "step": STEP}
    assert good["version"]["step"] == STEP
    for r in (r0, r1):
        assert r["model_version"]["step"] == STEP, r["rank"]
        for k, v in SECOND.items():
            np.testing.assert_array_equal(r["variables"][k], v, err_msg=f"rank {r['rank']} {k}")
    gap, same = answers_gap(good["answers"], want, "after /reload")
    assert same and gap <= TOL, gap


def test_buckets_start_at_the_data_axis(ranks):
    r0, r1 = (r["serve"] for r in ranks)
    check_buckets(r0, r1)
    assert len(r0["sizes"]) == 3 + 3 * 5 + 2  # warmup; 3 passes of the requests (1 + 1 + 3 calls); 2 probes


def test_answers_equal_the_jax_mesh_classifiers(ranks, jax_answers):
    r0 = ranks[0]["serve"]
    assert "error" not in r0["client"], r0["client"]
    gap, same = answers_gap(r0["client"]["initial"], jax_answers["first"], "mesh vs JAX")
    assert same and gap <= TOL, gap


def test_reload_on_the_mesh_swaps_every_rank(ranks, jax_answers):
    r0, r1 = (r["serve"] for r in ranks)
    check_reload(r0, r1, jax_answers["second"])


def test_nan_reload_keeps_the_old_tree_on_every_rank(ranks):
    r0, r1 = (r["serve"] for r in ranks)
    good, bad = r0["client"]["reloads"]
    assert bad["status"] == 409 and "non-finite" in bad["reply"]["error"], bad["reply"]
    assert bad["version"]["step"] == STEP
    gap, same = answers_gap(bad["answers"], good["answers"], "after the NaN reload")
    assert same and gap == 0.0
    for r in (r0, r1):  # the published tree of each rank is still step 12's
        assert r["model_version"]["step"] == STEP
        assert all(np.array_equal(r["variables"][k], v) for k, v in SECOND.items())


def test_a_reload_one_rank_cannot_load_keeps_the_old_tree_everywhere(ranks):
    """Rank 1's model dir lacks the step rank 0 chose: every rank refuses,
    and no rank probes or swaps."""
    r0, r1 = (r["rank1_cannot_load"] for r in ranks)
    reload = r0["client"]["reloads"][0]
    assert reload["status"] == 409 and "rejected on 1 of 2 ranks" in reload["reply"]["error"], reload
    assert len(r0["sizes"]) == len(r1["sizes"]) == 3 + 2 * 5  # warmup, 2 passes of the requests: no probe
    for r in (r0, r1):
        assert r["model_version"]["step"] is None
        assert all(np.array_equal(r["variables"][k], v) for k, v in FLAT.items())
    gap, same = answers_gap(reload["answers"], r0["client"]["initial"], "after the refused reload")
    assert same and gap == 0.0


def test_an_idle_rank_0_sends_heartbeats(monkeypatch):
    """With nothing to serve, rank 0's worker sends a NOOP header every
    HEARTBEAT_S, so that a follower's wait never reaches the group's
    timeout (a world of one here, HEARTBEAT_S shortened)."""
    from roomnet_tpu_torch.infer import server as S

    monkeypatch.setattr(S, "HEARTBEAT_S", 0.05)
    cfg = dataclasses.replace(tiny_config(), num_classes=4)
    try:
        clf = RoomNetClassifier(tschema.variables_from_numpy(FLAT, cfg, "cpu"), cfg, batch_size=BATCH,
                                class_labels=LABELS4, device="cpu", mesh=make_mesh(devices="cpu"))
        srv = ClassifierServer(clf, port=0)
        sent, send = [], srv._lockstep.send
        monkeypatch.setattr(srv._lockstep, "send", lambda op, *a, **kw: (sent.append(op), send(op, *a, **kw)))
        srv.start()
        time.sleep(1.0)
        srv.stop()
        assert sent[0] == S._NOOP and sent[-1] == S._STOP  # the start's handshake and the stop
        assert sent[1:-1].count(S._NOOP) >= 5 and set(sent[1:-1]) == {S._NOOP}
    finally:
        distributed.shutdown()


def test_sigterm_stop_ends_every_rank_with_0(ranks):
    r0, r1 = (r["serve"] for r in ranks)
    assert r0["rc"] == 0 and r1["rc"] == 0
    assert "error" not in r0 and "error" not in r1


def test_a_lost_follower_fails_rank_0_within_the_group_timeout(lost_follower):
    r0, r1 = lost_follower[0]["serve"], lost_follower[1]
    assert r1 == {"killed_at_call": 4}
    status, answer = r0["client"]["initial"]["single"]
    assert status == 503 and "device_error" in answer["error"], answer
    assert "out of lockstep" in r0["error"] and "rc" not in r0
    assert r0["serve_s"] < W.PG_TIMEOUT_S


def test_planted_faults_fail_the_checks(ranks, jax_answers):
    r0, r1 = (r["bucket_base_1"] for r in ranks)
    assert r0["buckets"] == [1, 2, 4, 8]
    with pytest.raises(AssertionError):
        check_buckets(r0, r1)
    r0, r1 = (r["reload_rank0_only"] for r in ranks)
    assert r0["model_version"]["step"] == STEP and r1["model_version"]["step"] is None
    with pytest.raises(AssertionError):
        check_reload(r0, r1, jax_answers["second"])


def test_world_of_one_equals_no_mesh():
    """make_mesh() without a group: a world of one; the mesh server's
    answers equal the server without a mesh, max |dprob| 0."""
    cfg = dataclasses.replace(tiny_config(), num_classes=4)
    servers = []
    try:
        for mesh in (None, make_mesh(devices="cpu")):
            clf = RoomNetClassifier(tschema.variables_from_numpy(FLAT, cfg, "cpu"), cfg, batch_size=BATCH,
                                    class_labels=LABELS4, device="cpu", mesh=mesh)
            servers.append(ClassifierServer(clf, port=0, warmup=True).start())
        plain, meshed = (classify_requests(s.port, REQUESTS) for s in servers)
        assert servers[1]._bucket_sizes == [1, 2, 4, 8]
        gap, same = answers_gap(meshed, plain, "world of one")
        assert same and gap == 0.0
    finally:
        for s in servers:
            s.stop()
        distributed.shutdown()
