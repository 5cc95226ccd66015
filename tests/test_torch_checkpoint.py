"""The port's checkpoint store (roomnet_tpu_torch/params/checkpoint.py), the
classifier's weight contract and `evaluate_checkpoints`, against roomnet_tpu.

  * every npz case of tests/test_checkpoint.py, in the port's store;
  * a checkpoint written by either package's store loads in the other's
    with equal flat dicts, optimizer state and step included (exact);
  * `evaluate_checkpoints` of both packages on one dir and list: equal
    entries (the same images through both, as in tests/test_torch_classify.py);
  * assigning `clf.variables` changes the predictions (the rolled head moves
    every argmax by one class), `_predict` folds a tree it is given for that
    call alone, and 20 assignments leave the conv's packed-weight cache as
    large as one does.
"""

import dataclasses
import gc
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from chip_smoke import tiny_config
from roomnet_tpu.infer import classify as JC
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import checkpoint as jckpt
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.infer import classify as TC
from roomnet_tpu_torch.models.roomnet import init_variables, param_count
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
from roomnet_tpu_torch.params import checkpoint as tckpt
from roomnet_tpu_torch.params import schema
from tests.tiny import TINY
from torch_port_util import LABELS4

cv2 = pytest.importorskip("cv2")
CFG = tiny_config()


@pytest.fixture
def variables():
    return init_variables(torch.Generator().manual_seed(0), CFG)


def _flat_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# -- the store: tests/test_checkpoint.py's npz cases ---------------------------


def test_save_load_roundtrip(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    store.save(variables, 42, suffix="0.91")
    loaded_flat, step = store.load(cfg=CFG)
    assert step == 42
    _flat_equal(loaded_flat, schema.flatten_variables(variables))


def test_keep_all_and_resume_latest(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    for step, acc in [(10, "0.5"), (30, "0.9"), (20, "0.7")]:
        store.save(variables, step, suffix=acc)
    assert len(os.listdir(tmp_path)) == 3
    assert "--0.9--30" in store.latest_path()
    assert store.load(cfg=CFG)[1] == 30
    assert [s for s, _, _ in store.list_checkpoints()] == [10, 20, 30]


def test_load_empty_dir_returns_none(tmp_path):
    store = tckpt.CheckpointStore(str(tmp_path))
    assert store.load(cfg=CFG) is None and store.latest_path() is None


def test_partial_restore_excludes_dense_head(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    store.save(variables, 5, opt_state_flat={"count": np.asarray(3)})
    fresh = init_variables(torch.Generator().manual_seed(9), CFG)
    restored_flat, step, opt = store.load(cfg=CFG, restore_head=False, with_opt_state=True)
    assert step == 5 and opt == {}  # the optimizer state is invalid with a fresh head
    merged = tckpt.merge_partial_restore(fresh, restored_flat, CFG)
    assert torch.equal(merged["blocks"][0]["conv"][0], variables["blocks"][0]["conv"][0])
    assert torch.equal(merged["dense"][0]["kernel"], fresh["dense"][0]["kernel"])
    assert not torch.allclose(merged["dense"][0]["kernel"], variables["dense"][0]["kernel"])


def test_partial_restore_skips_shape_mismatches_and_unknown_keys(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    store.save(variables, 7)
    bigger = dataclasses.replace(CFG, im_side=40)  # flat_len changes
    fresh = init_variables(torch.Generator().manual_seed(4), bigger)
    restored_flat, _ = store.load(cfg=bigger)
    restored_flat["blocks/9/conv/0"] = np.zeros((3, 3, 1, 1), np.float32)
    merged = tckpt.merge_partial_restore(fresh, restored_flat, bigger)
    assert torch.equal(merged["blocks"][0]["conv"][0], variables["blocks"][0]["conv"][0])
    assert torch.equal(merged["dense"][0]["kernel"], fresh["dense"][0]["kernel"])
    assert "blocks/9/conv/0" not in schema.flatten_tensors(merged)


def test_partial_restore_matches_roomnet_tpu(tmp_path):
    """The same fresh tree and restored dict through both packages' merge."""
    jfresh = jax_init(jax.random.PRNGKey(4), TINY)
    restored = jschema.flatten_variables(jax_init(jax.random.PRNGKey(5), TINY))
    restored = {k: v for k, v in restored.items() if not k.startswith("dense/")}
    want = jschema.flatten_variables(jckpt.merge_partial_restore(jfresh, restored, TINY))
    tfresh = schema.variables_from_numpy(jschema.flatten_variables(jfresh), CFG, "cpu")
    _flat_equal(schema.flatten_variables(tckpt.merge_partial_restore(tfresh, restored, CFG)), want)


def test_save_is_atomic_no_tmp_left(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    assert os.path.exists(store.save(variables, 3, suffix="0.5"))
    assert not any(".tmp" in f for f in os.listdir(tmp_path))
    tmp_file = tmp_path / "roomnet--0.9--99.tmp.npz"
    tmp_file.write_bytes(b"truncated garbage")
    assert "--3" in store.latest_path()
    tckpt.CheckpointStore(str(tmp_path))  # a fresh tmp file may be a live save: kept
    assert any(".tmp" in f for f in os.listdir(tmp_path))
    old = time.time() - 7200
    os.utime(tmp_file, (old, old))
    tckpt.CheckpointStore(str(tmp_path))  # a stale leftover: swept
    assert not any(".tmp" in f for f in os.listdir(tmp_path))


def test_opt_state_rides_along(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    opt_flat = {"count": torch.tensor(3, dtype=torch.int32), "mu/dense/0/kernel": np.ones((4, 2))}
    store.save(variables, 7, opt_state_flat=opt_flat)
    _, step, loaded_opt = store.load(cfg=CFG, with_opt_state=True)
    assert step == 7
    np.testing.assert_array_equal(loaded_opt["count"], 3)
    np.testing.assert_array_equal(loaded_opt["mu/dense/0/kernel"], np.ones((4, 2)))


def test_export_inference_strips_opt_state_and_matches_jax_manifest(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    out = store.export_inference(variables, str(tmp_path / "final" / "roomnet.npz"))
    with np.load(out) as data:
        raw = dict(data)
    assert not any(k.startswith(("opt/", "meta/")) for k in raw)
    assert param_count(schema.variables_from_numpy(raw, CFG, "cpu")) == param_count(variables)
    jout = str(tmp_path / "jax" / "roomnet.npz")
    jckpt.CheckpointStore(str(tmp_path / "jaxstore")).export_inference(
        jschema.unflatten_variables(raw, TINY), jout)
    mine = json.load(open(str(tmp_path / "final" / "roomnet.json")))
    theirs = json.load(open(str(tmp_path / "jax" / "roomnet.json")))
    assert mine == theirs and mine["format"] == "roomnet_tpu_flat_npz_v1"


def test_prune_keeps_newest_best_and_markers(tmp_path, variables):
    store = tckpt.CheckpointStore(str(tmp_path))
    for step, acc in [(10, "0.5"), (20, "0.95"), (30, "0.7"), (40, "0.8"), (50, "0.6")]:
        store.save(variables, step, suffix=acc)
    store.save(variables, 35, suffix="interrupt")
    deleted = store.prune(2)
    names = sorted(os.path.basename(p) for _, _, p in store.list_checkpoints())
    assert names == ["roomnet--0.6--50.npz", "roomnet--0.8--40.npz",
                     "roomnet--0.95--20.npz", "roomnet--interrupt--35.npz"]
    assert len(deleted) == 2 and store.load(cfg=CFG)[1] == 50
    with pytest.raises(ValueError):
        store.prune(0)


def test_open_store_refuses_orbax_directories(tmp_path):
    (tmp_path / "roomnet--0.8--12").mkdir()
    with pytest.raises(tckpt.OrbaxNotPorted, match="not ported yet"):
        tckpt.open_store(str(tmp_path))
    # npz files win where both are present (the JAX package's detection)
    tckpt.CheckpointStore(str(tmp_path)).save(init_variables(torch.Generator().manual_seed(1), CFG), 3)
    assert [s for s, _, _ in tckpt.open_store(str(tmp_path)).list_checkpoints()] == [3]


# -- files interchangeable with the JAX package's store -----------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_written_by_either_store_loads_in_the_other(tmp_path, writer):
    """Weights and TF1-Adam state (the port's train/optimizer keys, which
    are the JAX package's) through one package's save and both loads."""
    from roomnet_tpu_torch.train.optimizer import TF1Adam, flatten_opt_state

    jv = jax_init(jax.random.PRNGKey(2), TINY)
    flat = jschema.flatten_variables(jv)
    tv = schema.variables_from_numpy(flat, CFG, "cpu")
    train, _ = schema.partition_flat(schema.flatten_tensors(tv))
    opt = flatten_opt_state(TF1Adam(1e-3).init(train))
    opt_np = {k: v.numpy() for k, v in opt.items()}
    if writer == "jax":
        jckpt.CheckpointStore(str(tmp_path)).save(jv, 17, suffix="0.75", opt_state_flat=opt_np)
    else:
        tckpt.CheckpointStore(str(tmp_path)).save(tv, 17, suffix="0.75", opt_state_flat=opt)
    (path,) = [p for _, _, p in tckpt.CheckpointStore(str(tmp_path)).list_checkpoints()]
    assert os.path.basename(path) == "roomnet--0.75--17.npz"
    jflat, jstep, jopt = jckpt.CheckpointStore(str(tmp_path)).load(cfg=TINY, with_opt_state=True)
    tflat, tstep, topt = tckpt.CheckpointStore(str(tmp_path)).load(cfg=CFG, with_opt_state=True)
    assert jstep == tstep == 17
    _flat_equal(tflat, jflat)
    _flat_equal(tflat, flat)
    _flat_equal(topt, jopt)
    _flat_equal(topt, opt_np)
    assert set(topt) == {"count"} | {f"{m}/{k}" for m in ("mu", "nu") for k in train}
    with np.load(path) as data:
        assert data["meta/step"].dtype == np.int64 and int(data["meta/step"]) == 17


# -- the classifier's weight contract ------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """tests/test_infer_pipeline.py's tree A (init_variables(PRNGKey(0), TINY))
    and its rolled head B: the last dense layer's kernel columns and bias
    rolled by one class, an exact logit permutation."""
    flat_a = jschema.flatten_variables(jax_init(jax.random.PRNGKey(0), TINY))
    # A bias that keeps every logit above ReLU6's floor: no ties at 0.
    flat_a["dense/2/bias"] = flat_a["dense/2/bias"] + 1.0 + np.arange(4, dtype=np.float32) * 0.01
    flat_b = dict(flat_a)
    flat_b["dense/2/kernel"] = np.roll(flat_a["dense/2/kernel"], 1, axis=1)
    flat_b["dense/2/bias"] = np.roll(flat_a["dense/2/bias"], 1)
    return flat_a, flat_b


def _images(n=12, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, CFG.im_side, CFG.im_side, 3), np.uint8)


def test_assigning_variables_changes_the_predictions(weights):
    """The fault the port had: the fold was made once at construction, so an
    assignment changed nothing. Now every argmax moves by one class."""
    flat_a, flat_b = weights
    clf = TC.RoomNetClassifier(schema.variables_from_numpy(flat_a, CFG, "cpu"), CFG, batch_size=4,
                               class_labels=LABELS4, device="cpu")
    x = _images()
    ids_a, probs_a = clf.predict(x)
    clf.variables = schema.variables_from_numpy(flat_b, CFG, "cpu")
    ids_b, probs_b = clf.predict(x)
    np.testing.assert_array_equal(ids_b, (ids_a + 1) % 4)
    np.testing.assert_allclose(probs_b, np.roll(probs_a, 1, axis=1), rtol=0, atol=1e-6)
    _flat_equal(schema.flatten_variables(clf.variables), flat_b)
    # the JAX classifier on the same trees agrees
    jclf = JC.RoomNetClassifier(jschema.unflatten_variables(flat_a, TINY), TINY, batch_size=4,
                                class_labels=LABELS4)
    jclf.variables = jschema.unflatten_variables(flat_b, TINY)
    jids, jprobs = (np.asarray(a) for a in jclf._predict(jclf.variables, x))
    np.testing.assert_array_equal(ids_b, jids)
    np.testing.assert_allclose(probs_b, jprobs, rtol=0, atol=1e-5)


def test_predict_with_another_tree_folds_it_for_that_call_alone(weights):
    flat_a, flat_b = weights
    clf = TC.RoomNetClassifier(schema.variables_from_numpy(flat_a, CFG, "cpu"), CFG, batch_size=4,
                               class_labels=LABELS4, device="cpu")
    x = torch.from_numpy(_images(4))
    published = clf._weights
    ids_a, _ = clf._predict(clf.variables, x)
    ids_b, _ = clf._predict(schema.variables_from_numpy(flat_b, CFG, "cpu"), x)
    assert torch.equal(ids_b, (ids_a + 1) % 4)
    assert clf._weights is published  # the probe's tree was never published
    assert torch.equal(clf._predict(clf.variables, x)[0], ids_a)


def test_swaps_do_not_grow_the_packed_weight_cache(weights):
    """The conv packs each fold's kernels once (keyed by tensor): 20
    assignments leave as many cache entries as one. On the CPU the wrapper
    runs the plain conv, so this packs each fold's kernels as the CUDA
    wrapper does at its launches."""
    flat_a, flat_b = weights
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)  # the fold casts: new tensors per swap
    clf = TC.RoomNetClassifier(schema.variables_from_numpy(flat_a, cfg, "cpu"), cfg, batch_size=4,
                               device="cpu")

    def pack_current():
        for blk in clf._weights[1]["blocks"]:
            for kern, *_ in blk["layers"]:
                KC.packed_kernel(kern, cfg.compute_dtype)
        gc.collect()
        return len(KC._packed)

    sizes = []
    for i in range(20):
        clf.variables = schema.variables_from_numpy(flat_b if i % 2 else flat_a, cfg, "cpu")
        sizes.append(pack_current())
    assert sizes == [sizes[0]] * 20, sizes
    assert sizes[0] >= 3  # this fold's three convs are in it


# -- evaluate_checkpoints --------------------------------------------------------


def _write_images(d, n):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(1)
    paths = []
    for i in range(n):
        p = os.path.join(d, f"im {i}.png")
        cv2.imwrite(p, rng.randint(0, 256, (40 + 4 * i, 48, 3), np.uint8))
        paths.append(p)
    return paths


def test_evaluate_checkpoints_matches_roomnet_tpu(tmp_path, weights):
    """One dir (B at 100, A at 200, B as an 'interrupt' marker at 300) and
    one list labelled with A's predictions, through both packages: equal
    entries, A scored 1.0 and B 0.0, best step 200."""
    flat_a, flat_b = weights
    paths = _write_images(str(tmp_path / "imgs"), 6)
    store = jckpt.CheckpointStore(str(tmp_path / "ckpts"))
    var_a, var_b = (jschema.unflatten_variables(f, TINY) for f in (flat_a, flat_b))
    store.save(var_b, 100, suffix="0.5000")
    store.save(var_a, 200, suffix="0.9000")
    store.save(var_b, 300, suffix="interrupt")
    ids, _, _ = JC.RoomNetClassifier(var_a, TINY, batch_size=4, class_labels=LABELS4).predict_paths(paths)
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{p} {int(i)}\n" for p, i in zip(paths, ids)))
    want = JC.evaluate_checkpoints(str(tmp_path / "ckpts"), str(lst), TINY, batch_size=4,
                                   class_labels=LABELS4)
    got = TC.evaluate_checkpoints(str(tmp_path / "ckpts"), str(lst), CFG, batch_size=4,
                                  class_labels=LABELS4, device="cpu")
    assert got == want
    by_step = {e["step"]: e for e in got["checkpoints"]}
    assert [e["step"] for e in got["checkpoints"]] == [100, 200, 300]
    assert by_step[200]["accuracy"] == 1.0 and by_step[100]["accuracy"] == 0.0
    assert by_step[100]["name_accuracy"] == 0.5 and by_step[300]["name_accuracy"] is None
    assert got["best"]["step"] == 200


def test_evaluate_checkpoints_refuses_empty_and_orbax(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("")
    with pytest.raises(FileNotFoundError):
        TC.evaluate_checkpoints(str(tmp_path / "nothing"), str(lst), CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        TC.evaluate_checkpoints(str(tmp_path / "nothing"), str(lst), CFG, backend="orbax", device="cpu")
    (tmp_path / "orbax" / "roomnet--0.8--20").mkdir(parents=True)
    with pytest.raises(tckpt.OrbaxNotPorted):
        TC.evaluate_checkpoints(str(tmp_path / "orbax"), str(lst), CFG, device="cpu")
