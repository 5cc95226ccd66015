"""The port's Trainer on a mesh (roomnet_tpu_torch/train/loop.py, Scale-out)
on the CPU: two ranks over gloo (tests/torch_dp_worker.py) at tests/tiny.py's
geometry with 2 classes.

The counterparts of the twelve mesh, sharded-feed and orbax tests of
tests/test_train_loop.py (their JAX mesh of 8 virtual devices is a world of
2 here, so batch 5 rounds to 6 and 45 to 46) and of
tests/test_distributed.py's cross-process sharded feed, end-to-end Trainer
and multihost checkpoint. Then both packages' Trainers from one JAX
checkpoint: the port on two ranks against the JAX Trainer on
`make_mesh(2, 1)`, at the tolerances of tests/test_torch_train_loop_parity.py
(params, BN moving stats and the Adam count within 1e-4; the Adam moments
under batch statistics within MOMENT_SHARE of each tensor's largest), at
batch 8 (4 rows a rank), in four runs that cover the replicated and the
sharded feed, one and three steps per call, and inference BN and batch
statistics; and with unreadable rows on one rank only under the sharded
feed, where a mean over ranks would differ from the global-count division.

Under batch statistics those limits are raised to FLOOR_TIMES the JAX
Trainer's own gap between one device and the mesh on the same run (its
floor) where that is larger: a few CE gradients are small differences of
large sums there, and TF1 Adam's m / sqrt(v) turns their rounding into
steps, so the gap depends on the batches. Measured at batch 8 after 6 steps
over four seeds of the list split: the port on two ranks against the JAX
mesh 7.6e-6, 3.9e-4, 7.6e-4 and 8e-7 (params, |d| / (1 + |want|)), the JAX
mesh against one device 7.2e-6, 3.8e-4, 9.1e-4 and 1e-5; moments up to
0.093 and 0.099 of their largest. The split here is seeded (0).

Every two-rank run is one process pair (`port` fixture), which runs them in
turn; each test reads its run.
"""

import dataclasses
import json
import os
import shutil
import time

import jax
import numpy as np
import pytest

from chip_smoke import state_gap
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.params.checkpoint import CheckpointStore as JaxStore
from roomnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from roomnet_tpu.train import loop as jloop
from roomnet_tpu.train.optimizer import flatten_opt_state as jax_flatten_opt
from roomnet_tpu.train.step import init_train_state as jax_init_state
from roomnet_tpu_torch.data.dataset import extract_fpaths
from roomnet_tpu_torch.params.checkpoint import CheckpointStore
from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore
from roomnet_tpu_torch.train import loop as tloop
from tests import torch_dp_worker as W
from tests.tiny import TINY

cv2 = pytest.importorskip("cv2")
JAX_CFG = dataclasses.replace(TINY, num_classes=2)
TOL = 1e-4
MOMENT_SHARE = 5e-3
FLOOR_TIMES = 2.0
FOREVER = 1 << 62
PARITY_BATCH = 8  # 4 rows a rank
PARITY_STEPS = 4  # a validation and a checkpoint at step 3
# (feed, steps per call, batch statistics): each level of each factor twice.
PARITY = {"rep_1_infbn": ("replicated", 1, False), "shard_3_infbn": ("sharded", 3, False),
          "rep_3_trainbn": ("replicated", 3, True), "shard_1_trainbn": ("sharded", 1, True)}


def _images(d, per_class, rng):
    for cls, base in [("Kitchen", 40), ("Bedroom", 200)]:
        (d / cls).mkdir(parents=True)
        for i in range(per_class):
            im = np.clip(rng.randint(base - 30, base + 60, (40, 48, 3)), 0, 255)
            cv2.imwrite(str(d / cls / f"im_{i}.png"), im.astype(np.uint8))


def _lists(root, data):
    lists = {"train_list_fpath": str(root / "train_list.txt"), "val_list_fpath": str(root / "val_list.txt"),
             "label_mappings_fpath": str(root / "labels.json")}
    extract_fpaths(str(data), *lists.values(), seed=0)
    return lists


def _bad_data(root):
    """8 images a class and one unreadable file, listed for training and
    validation by hand (extract_fpaths would drop it)."""
    d = root / "data"
    rng = np.random.RandomState(0)
    for cls in ("Kitchen", "Bedroom"):
        (d / cls).mkdir(parents=True)
        for i in range(8):
            cv2.imwrite(str(d / cls / f"im_{i}.png"), rng.randint(0, 255, (40, 48, 3), np.uint8))
    (d / "Kitchen" / "bad.png").write_text("not an image")
    paths = sorted(str(p) for cls in ("Kitchen", "Bedroom") for p in (d / cls).iterdir())
    (root / "train_list.txt").write_text("".join(f"{p} {int('Bedroom' in p)}\n" for p in paths))
    (root / "val_list.txt").write_text("".join(f"{p} {int('Bedroom' in p)}\n" for p in paths[:4]))
    return {"train_list_fpath": str(root / "train_list.txt"), "val_list_fpath": str(root / "val_list.txt"),
            "label_mappings_fpath": str(root / "labels.json")}


def _start_checkpoint(root) -> str:
    """Step 0 in the JAX package's npz store: its init with random BN fields
    and a fresh Adam state (tests/test_torch_train_loop_parity.py)."""
    rng = np.random.RandomState(0)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(5), JAX_CFG))
    for k in flat:
        if "bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1, "mean": rng.randn(*n) * 0.1,
                       "var": rng.rand(*n) + 0.5}[k.rsplit("/", 1)[1]].astype(np.float32)
    variables = jschema.unflatten_variables(flat, JAX_CFG)
    return JaxStore(str(root / "start")).save(
        variables, 0, opt_state_flat=jax_flatten_opt(jax_init_state(variables).opt_state))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    out = {"root": root}
    for name in ("main", "corrupt"):
        (root / name).mkdir()
        _images(root / name / "data", 10, np.random.RandomState(0))
        out[name] = dict(data_dir=str(root / name / "data"), **_lists(root / name, root / name / "data"))
    for p in (root / "corrupt" / "data").rglob("*.png"):
        p.write_text("corrupted")
    (root / "bad").mkdir()
    out["bad"] = dict(data_dir=str(root / "bad" / "data"), **_bad_data(root / "bad"))
    out["start"] = _start_checkpoint(root)
    return out


def _tc(data, which, name, **kw) -> dict:
    """TrainConfig kwargs over data[which], with a model dir and stats file
    of the run's own."""
    root = data["root"]
    base = dict(data[which], stats_fpath=str(root / f"stats_{name}.json"), model_dir=str(root / f"models_{name}"),
                img_side=32, train_steps=1000, save_freq=1000, val_batch_size=4, learn_rate=1e-3, l2_coeff=1e-4,
                seed=0, stall_timeout_s=0, phases=[dict(until_step=FOREVER, batch_size=8)])
    base.update(kw)
    return base


def _parity_tc(data, name, feed, spc, bn) -> dict:
    mdir = data["root"] / f"models_{name}"
    mdir.mkdir(exist_ok=True)
    shutil.copy(data["start"], mdir)
    return _tc(data, "main", name, save_freq=3, val_batch_size=2, l2_coeff=6e-2, feed_mode=feed, steps_per_call=spc,
               phases=[dict(until_step=FOREVER, batch_size=PARITY_BATCH, compute_bn_mean_var=bn,
                            update_bn_moving=bn)])


def _runs(data) -> dict:
    """Every two-rank run, by name."""
    runs = {
        "dp_scan": dict(tc=_tc(data, "main", "dp_scan", steps_per_call=3, save_freq=5), steps=6, log_every=1),
        "feed_rep": dict(tc=_tc(data, "main", "feed_rep"), steps=4),
        "feed_shard": dict(tc=_tc(data, "main", "feed_shard", feed_mode="sharded"), steps=4),
        "feed_shard_scan": dict(tc=_tc(data, "main", "feed_shard_scan", feed_mode="sharded", steps_per_call=3),
                                steps=6, log_every=1),
        "shard_unreadable": dict(tc=_tc(data, "bad", "shard_unreadable", feed_mode="sharded"), steps=4),
        "rep_unreadable": dict(tc=_tc(data, "bad", "rep_unreadable"), steps=4),
        "rounds": dict(tc=_tc(data, "main", "rounds", val_batch_size=3, save_freq=2,
                              phases=[dict(until_step=FOREVER, batch_size=5)]), steps=3, mesh_batch=(5, 45, 1, 8)),
        "shard_small": dict(tc=_tc(data, "main", "shard_small", feed_mode="sharded",
                                   phases=[dict(until_step=FOREVER, batch_size=32)]), steps=2),
        "shard_corrupt": dict(tc=_tc(data, "corrupt", "shard_corrupt", feed_mode="sharded"), steps=50,
                              may_raise=True),
        "scan_small": dict(tc=_tc(data, "main", "scan_small", steps_per_call=2,
                                  phases=[dict(until_step=FOREVER, batch_size=32)]), steps=4),
        "e2e": dict(tc=_tc(data, "main", "e2e", save_freq=3, phases=[dict(until_step=FOREVER, batch_size=5)]),
                    steps=5, log_every=1),
        "orbax_dp": dict(tc=_tc(data, "main", "orbax_one", ckpt_backend="orbax", save_freq=3), steps=4),
        "model_axis": dict(tc=_tc(data, "main", "model_axis"), steps=2, mesh=(1, 2)),
        "shard_unreadable_parity": dict(tc=_parity_tc(data, "shard_unreadable_parity", "sharded", 1, True)
                                        | dict(data["bad"]), steps=4),
    }
    for name, (feed, spc, bn) in PARITY.items():
        runs[f"parity_{name}"] = dict(tc=_parity_tc(data, f"parity_{name}", feed, spc, bn), steps=PARITY_STEPS)
    return runs


@pytest.fixture(scope="module")
def port(data):
    """{run: [rank 0's result, rank 1's]} of every two-rank run. Before the
    spawn, a one-process Trainer writes a DCP checkpoint at step 3 into the
    dir that run orbax_dp resumes (and continues to step 6)."""
    tc = _tc(data, "main", "orbax_one", ckpt_backend="orbax", save_freq=3)
    tc["phases"] = tuple(tloop.Phase(**p) for p in tc["phases"])
    tloop.Trainer(tloop.TrainConfig(**tc), W.tiny(2), device="cpu").train(total_steps=4, log_every=100)
    res = W.spawn("trainers", 2, data["root"] / "spawn", timeout_s=300, runs=_runs(data))
    return {name: [r[name] for r in res] for name in res[0]}


def _jax_state(state) -> dict:
    flat = {"meta/step": np.asarray(state.step), **jax.device_get(state.train_vars),
            **jax.device_get(state.frozen_vars)}
    flat.update({f"opt/{k}": np.asarray(v) for k, v in jax_flatten_opt(state.opt_state).items()})
    return flat


def _gap(got: dict, want: dict) -> tuple[float, float]:
    """(largest |d| / (1 + |want|) over params, BN stats and step; largest
    |d| of an Adam moment over its tensor's largest |value|)."""
    params = max(float((np.abs(np.asarray(got[k], np.float64) - want[k]) / (1 + np.abs(want[k]))).max())
                 for k in want if not k.startswith(("opt/mu/", "opt/nu/")))
    moments = max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max() / np.abs(want[k]).max())
                  for k in want if k.startswith(("opt/mu/", "opt/nu/")))
    return params, moments


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX Trainer on make_mesh(2, 1) over 2 of the 8 virtual CPU
    devices: {name: (state, TrainConfig kwargs, floor)}. One inference-BN
    run serves both inference-BN parity runs (their masks weigh rows by one
    and change no value there); each batch-statistics run, in its parity
    run's configuration (the sharded feed and the multi-step call take the
    masked step), also runs on one device for the floor."""
    out = {}
    configs = {"infbn": ("main", "replicated", 1, False, PARITY_STEPS),
               "rep_3_trainbn": ("main", "replicated", 3, True, PARITY_STEPS),
               "shard_1_trainbn": ("main", "sharded", 1, True, PARITY_STEPS),
               "shard_unreadable": ("bad", "sharded", 1, True, 4)}
    for name, (which, feed, spc, bn, steps) in configs.items():
        states = {}
        for on_mesh in (True, False) if bn else (True,):
            tc = _parity_tc(data, f"jax_{name}_{int(on_mesh)}", feed, spc, bn) | dict(data[which])
            tc["phases"] = tuple(jloop.Phase(**p) for p in tc["phases"])
            states[on_mesh] = (_jax_state(jloop.Trainer(jloop.TrainConfig(**tc), JAX_CFG,
                                                        mesh=jax_make_mesh(2, 1) if on_mesh else None)
                                          .train(total_steps=steps, log_every=100)), tc)
        floor = _gap(states[True][0], states[False][0]) if bn else (0.0, 0.0)
        out[name] = (*states[True], floor)
    return out


def _same_on_both_ranks(run):
    a, b = run[0]["state"], run[1]["state"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return a


def _check(got: dict, want: dict, floor: tuple[float, float] | None):
    """got within TOL of want (params, BN stats, Adam count and, with
    inference BN, moments). Under batch statistics (a floor given): params
    within max(TOL, FLOOR_TIMES x the floor's) in |d| / (1 + |want|), the
    Adam moments within max(MOMENT_SHARE, FLOOR_TIMES x the floor's) of each
    tensor's largest magnitude."""
    if floor is None:
        state_gap(got, want, TOL)
        return
    params, moments = _gap(got, want)
    assert params <= max(TOL, FLOOR_TIMES * floor[0]), (params, floor)
    assert moments <= max(MOMENT_SHARE, FLOOR_TIMES * floor[1]), (moments, floor)


# -- the twelve of tests/test_train_loop.py ------------------------------------


def test_trainer_with_data_parallel_mesh(port):
    """Trainer over a two-rank DP mesh: the step count, one state on both."""
    assert int(_same_on_both_ranks(port["feed_rep"])["meta/step"]) == 4


def test_trainer_multi_step_with_dp_mesh(port):
    """steps_per_call=3 over the mesh: (K, rows) stacks of each rank's rows."""
    state = _same_on_both_ranks(port["dp_scan"])
    assert int(state["meta/step"]) == 6
    assert "Step 6 loss" in port["dp_scan"][0]["stdout"]


def test_trainer_sharded_feed_matches_replicated(port):
    """Each rank decodes only its rows under the sharded feed, the rows the
    replicated feed gives it: the two runs are equal, bit for bit."""
    a, b = _same_on_both_ranks(port["feed_rep"]), _same_on_both_ranks(port["feed_shard"])
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_trainer_sharded_feed_with_multi_step(port):
    assert int(_same_on_both_ranks(port["feed_shard_scan"])["meta/step"]) == 6


def test_trainer_sharded_feed_masks_unreadable_rows(port):
    """An unreadable row in one rank's slice is masked out of the loss, not
    skipped (a skip on one rank would desync the collectives)."""
    assert int(_same_on_both_ranks(port["shard_unreadable"])["meta/step"]) == 4
    assert "skipping" not in port["shard_unreadable"][0]["stdout"]


def test_trainer_replicated_mesh_masks_divisibility_pad(port):
    """A batch shrunk by an unreadable file (15 rows) is cycle-padded to the
    data-axis multiple and the pad masked; the run trains on."""
    assert int(_same_on_both_ranks(port["rep_unreadable"])["meta/step"]) == 4


def test_trainer_dp_rounds_indivisible_batch(port, data):
    """Batch sizes round UP to the data axis (ceil, never floor): 5 -> 6,
    45 -> 46, 1 -> 2; the run with batch 5 and validation batch 3 trains,
    validates over the mesh and checkpoints."""
    run = port["rounds"]
    assert run[0]["mesh_batch"] == {5: 6, 45: 46, 1: 2, 8: 8}
    assert int(_same_on_both_ranks(run)["meta/step"]) == 3
    assert "batch 5 -> 6 (multiple of data axis 2)" in run[0]["stdout"]
    with open(data["root"] / "stats_rounds.json") as f:
        assert [e["step"] for e in json.load(f)] == [2]


def _slowed(tr, seconds):
    orig = tr._step_fn

    def slow_step_fn(ph, **kw):
        fn = orig(ph, **kw)

        def wrapped(*a):
            time.sleep(seconds)
            return fn(*a)

        return wrapped

    tr._step_fn = slow_step_fn


def test_stall_orbax_backend_falls_back_to_local_npz_dump(data):
    """On the orbax backend (a collective save, which a watchdog thread
    cannot drive) a stall writes a local npz dump under model_dir/emergency/,
    loadable and resumable."""
    tc = _tc(data, "main", "stall_orbax", ckpt_backend="orbax", stall_timeout_s=0.25,
             phases=[dict(until_step=FOREVER, batch_size=4)])
    tc["phases"] = tuple(tloop.Phase(**p) for p in tc["phases"])
    tr = tloop.Trainer(tloop.TrainConfig(**tc), W.tiny(2), device="cpu")
    _slowed(tr, 1.0)
    tr.train(total_steps=3, log_every=1)
    emdir = os.path.join(tc["model_dir"], "emergency")
    assert [c for c in os.listdir(emdir) if "--stall-rank0--" in c], os.listdir(emdir)
    restored = CheckpointStore(emdir).load(with_opt_state=True)
    assert restored is not None and restored[1] >= 1


def test_trainer_with_orbax_backend(data):
    """The Trainer with the orbax (DCP) backend: acc-named checkpoint
    directories, then a resume from the latest."""
    tc = _tc(data, "main", "orbax", ckpt_backend="orbax", save_freq=5,
             phases=[dict(until_step=FOREVER, batch_size=4)])
    tc["phases"] = tuple(tloop.Phase(**p) for p in tc["phases"])
    state = tloop.Trainer(tloop.TrainConfig(**tc), W.tiny(2), device="cpu").train(total_steps=6, log_every=100)
    assert int(state.step) == 6
    ckpts = OrbaxCheckpointStore(tc["model_dir"]).list_checkpoints()
    assert [s for s, _, _ in ckpts] == [5] and os.path.isdir(ckpts[0][2])
    state2 = tloop.Trainer(tloop.TrainConfig(**tc), W.tiny(2), device="cpu").train(total_steps=2, log_every=100)
    assert int(state2.step) == 7  # resumed at step 5


def test_trainer_sharded_feed_dataset_smaller_than_batch(port):
    """Batch 32 over 18 training images: clamped to the dataset, then to the
    sharded quantum (18), before the rows are sliced."""
    assert int(_same_on_both_ranks(port["shard_small"])["meta/step"]) == 2


def test_trainer_sharded_feed_refuses_fully_unreadable_dataset(port):
    """A rank whose slice stays unreadable for a whole epoch raises (both
    ranks here) instead of training on masked zeros forever."""
    for r in port["shard_corrupt"]:
        assert r["error"] is not None and "unreadable" in r["error"], r["error"]


def test_trainer_scanned_steps_mesh_dataset_smaller_than_batch(port):
    """steps_per_call=2 with a dataset smaller than the batch: the feeder's
    clamped batch is re-padded to the data-axis multiple (masked)."""
    assert int(_same_on_both_ranks(port["scan_small"])["meta/step"]) == 4


# -- tests/test_distributed.py ---------------------------------------------------


def test_cross_process_sharded_feed_matches_replicated(port):
    """Two processes, each decoding only its 4 rows: 4 steps equal to the
    replicated feed's within 1e-5, and the ranks end bit-identical."""
    a, b = _same_on_both_ranks(port["feed_shard"]), _same_on_both_ranks(port["feed_rep"])
    state_gap(a, b, 1e-5)
    assert float(a["dense/0/kernel"].sum()) == float(port["feed_shard"][1]["state"]["dense/0/kernel"].sum())


def test_cross_process_trainer_end_to_end(port, data):
    """The full Trainer over two processes: gradients all-reduced across
    the process boundary, rank 0 alone writes the npz checkpoint and the
    stats, both ranks end with the same params."""
    assert int(_same_on_both_ranks(port["e2e"])["meta/step"]) == 5
    ckpts = os.listdir(data["root"] / "models_e2e")
    assert len(ckpts) == 1 and ckpts[0].endswith("--3.npz") and ".tmp" not in ckpts[0]
    with open(data["root"] / "stats_e2e.json") as f:
        assert [e["step"] for e in json.load(f)] == [3]
    assert "Validated at step 3" in port["e2e"][0]["stdout"] and "Validated" not in port["e2e"][1]["stdout"]


def test_cross_process_dp_step_and_multihost_checkpoint(data, tmp_path):
    """A DP step on two processes, saved collectively by both into the DCP
    store (synchronously, then asynchronously and waited for), restores
    bit-exact on this single process."""
    rng = np.random.RandomState(0)
    from roomnet_tpu_torch.models.roomnet import init_variables
    from roomnet_tpu_torch.params import schema

    import torch

    flat = schema.flatten_variables(init_variables(torch.Generator().manual_seed(0), W.tiny()))
    x = rng.randint(0, 255, (8, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 4, (8,)).astype(np.int32)
    ckpt_dir = str(tmp_path / "dcp_multihost")
    res = W.spawn("dp_checkpoint", 2, tmp_path / "spawn", flat=flat, x=x, y=y, ckpt_dir=ckpt_dir)
    store = OrbaxCheckpointStore(ckpt_dir, async_save=False)
    assert [(s, sfx) for s, sfx, _ in store.list_checkpoints()] == [(1, "dp"), (2, "async")]
    for path in (None, store.list_checkpoints()[0][2]):
        var_flat, step, opt_flat = store.load(path, with_opt_state=True)
        assert step == (2 if path is None else 1) and int(opt_flat["count"]) == 1
        want = res[0]
        for k, v in var_flat.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        for k, v in opt_flat.items():
            np.testing.assert_array_equal(v, want[f"opt/{k}"], err_msg=k)
    assert any(f.endswith(".distcp") for f in os.listdir(store.list_checkpoints()[0][2]))


# -- beyond the JAX tests ------------------------------------------------------------


def test_orbax_checkpoints_resume_across_topologies(port, data):
    """A DCP checkpoint written by one process (step 3) resumes on two ranks,
    which save step 6 collectively; one process resumes that."""
    run = port["orbax_dp"]
    assert "Model restored at step 3" in run[0]["stdout"]
    assert int(_same_on_both_ranks(run)["meta/step"]) == 7
    mdir = data["root"] / "models_orbax_one"
    assert [s for s, _, _ in OrbaxCheckpointStore(str(mdir)).list_checkpoints()] == [3, 6]
    tc = _tc(data, "main", "orbax_one", ckpt_backend="orbax", save_freq=1000)
    tc["phases"] = tuple(tloop.Phase(**p) for p in tc["phases"])
    tr = tloop.Trainer(tloop.TrainConfig(**tc), W.tiny(2), device="cpu")
    assert int(tr.init_state().step) == 6


def test_model_axis_replicates_rows(port):
    """A (1, 2) mesh: both ranks on one data coordinate hold the whole batch
    and compute the same step. The Trainer still replicates along 'model',
    as the JAX Trainer does (it never applies variables_shardings); tensor
    parallelism runs in the step (tests/test_torch_tensor_parallel.py)."""
    assert int(_same_on_both_ranks(port["model_axis"])["meta/step"]) == 2


@pytest.mark.parametrize("name", list(PARITY))
def test_two_ranks_match_the_jax_trainer_on_a_mesh(port, jax_runs, data, name):
    """From one JAX checkpoint, the port's Trainer on two ranks against the
    JAX Trainer on make_mesh(2, 1): the state after 4 steps within the
    docstring's tolerances, the same stats entry at step 3 (validation
    gathered over the ranks) and the same checkpoint names."""
    bn = PARITY[name][2]
    want, jtc, floor = jax_runs[name if bn else "infbn"]
    got = _same_on_both_ranks(port[f"parity_{name}"])
    assert int(got["meta/step"]) == int(want["meta/step"]) == PARITY_STEPS
    _check(got, want, floor if bn else None)
    with open(data["root"] / f"stats_parity_{name}.json") as f, open(jtc["stats_fpath"]) as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(data["root"] / f"models_parity_{name}")) == sorted(os.listdir(jtc["model_dir"]))


def _unreadable_hits(data, steps: int) -> list:
    """(step, rank) of each step of a PARITY_BATCH run over the bad dataset
    whose rows hold the unreadable file (the feeder's epoch order)."""
    from roomnet_tpu_torch.data.loader import TrainFeeder

    with open(data["bad"]["train_list_fpath"]) as f:
        feeder = TrainFeeder(f.readlines(), batch_size=PARITY_BATCH, shuffle=True, seed=0, start=False)
    hits = []
    for step in range(steps):
        epoch, b = divmod(step, feeder.batches_per_epoch)
        rows = feeder.fpaths[feeder._epoch_order(epoch)[b * PARITY_BATCH:(b + 1) * PARITY_BATCH]]
        hits += [(step, i // (PARITY_BATCH // 2)) for i, line in enumerate(rows) if "bad.png" in line]
    return hits


def test_unreadable_rows_on_one_rank_match_the_jax_trainer(port, jax_runs, data):
    """The sharded feed with the unreadable file in one rank's rows only,
    under batch statistics: the global-count division gives the JAX
    Trainer's state (a mean over ranks would weigh that rank's 3 real rows
    as the other rank's 4)."""
    assert _unreadable_hits(data, 4), "the unreadable file is in no batch of the run"
    want, _, floor = jax_runs["shard_unreadable"]
    _check(_same_on_both_ranks(port["shard_unreadable_parity"]), want, floor)
