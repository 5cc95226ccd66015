"""The port's sharded, asynchronous checkpoint store
(roomnet_tpu_torch/params/orbax_io.py, DCP directories) on one process: the
behaviours of tests/test_checkpoint.py's orbax tests (round trip, async
save and wait, partial restore, retention), `open_store`'s choice of store,
and the refusal, by name, of a directory the JAX package's orbax store
wrote. Values are compared exactly: the store writes and reads f32 bytes.
"""

import os

import jax
import numpy as np
import pytest
import torch

from roomnet_tpu.params.orbax_io import OrbaxCheckpointStore as JaxOrbaxStore
from roomnet_tpu_torch.models.roomnet import init_variables
from roomnet_tpu_torch.params import checkpoint as tckpt
from roomnet_tpu_torch.params import orbax_io
from roomnet_tpu_torch.params import schema
from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore
from tests.tiny import TINY
from tests.torch_dp_worker import tiny

CFG = tiny()


@pytest.fixture(scope="module")
def variables():
    return init_variables(torch.Generator().manual_seed(0), CFG)


def test_orbax_backend_roundtrip(tmp_path, variables):
    store = OrbaxCheckpointStore(str(tmp_path / "orbax"), async_save=False)
    path = store.save(variables, 12, suffix="0.88", opt_state_flat={"count": np.asarray(3, np.int32),
                                                                    "mu/dense/0/kernel": np.ones((256, 16))})
    assert os.path.basename(path) == "roomnet--0.88--12" and store.latest_path() == path
    assert os.path.isfile(os.path.join(path, ".metadata"))
    var_flat, step, opt = store.load(cfg=CFG, with_opt_state=True)
    assert step == 12 and int(opt["count"]) == 3 and opt["count"].dtype == np.int32
    np.testing.assert_array_equal(opt["mu/dense/0/kernel"], np.ones((256, 16)))
    want = schema.flatten_variables(variables)
    assert set(var_flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(var_flat[k], want[k], err_msg=k)
        assert var_flat[k].dtype == want[k].dtype
    # partial restore drops the head and the optimizer state here too
    var_flat2, _, opt2 = store.load(cfg=CFG, restore_head=False, with_opt_state=True)
    assert not any(k.startswith("dense/") for k in var_flat2) and opt2 == {}
    assert set(var_flat2) == {k for k in want if not k.startswith("dense/")}


def test_orbax_async_save_waits(tmp_path, variables):
    store = OrbaxCheckpointStore(str(tmp_path / "orbax_async"), async_save=True)
    store.save(variables, 5, suffix="0.7")
    store.save(variables, 6, suffix="0.8")  # waits for the first
    store.wait()  # async write must land before load
    assert [s for s, _, _ in store.list_checkpoints()] == [5, 6]
    var_flat, step = store.load(cfg=CFG)
    assert step == 6
    want = schema.flatten_variables(variables)
    np.testing.assert_array_equal(var_flat["dense/0/kernel"], want["dense/0/kernel"])
    store.wait()  # nothing in flight: a no-op


def test_unfinished_directories_are_not_listed(tmp_path, variables):
    """A save without DCP's .metadata (written last) never resumes."""
    store = OrbaxCheckpointStore(str(tmp_path), async_save=False)
    store.save(variables, 3, suffix="0.5")
    (tmp_path / "roomnet--0.9--9").mkdir()
    (tmp_path / "roomnet--0.9--9" / "__0_0.distcp").write_bytes(b"partial")
    assert [s for s, _, _ in store.list_checkpoints()] == [3]
    assert store.load(cfg=CFG)[1] == 3


def test_prune_orbax_backend(tmp_path, variables):
    """The npz store's retention on directories: newest N regular, the best
    and every marker survive, and resume-latest still works."""
    store = OrbaxCheckpointStore(str(tmp_path), async_save=False)
    for step, acc in [(1, "0.4"), (2, "0.9"), (3, "0.5"), (4, "0.6")]:
        store.save(variables, step, suffix=acc)
    store.save(variables, 5, suffix="interrupt")
    deleted = store.prune(1)
    assert sorted(os.path.basename(p) for p in deleted) == ["roomnet--0.4--1", "roomnet--0.5--3"]
    assert [(s, sfx) for s, sfx, _ in store.list_checkpoints()] == [(2, "0.9"), (4, "0.6"), (5, "interrupt")]
    assert not (tmp_path / "roomnet--0.4--1").exists()
    loaded_flat, step = store.load(cfg=CFG)
    assert step == 5 and loaded_flat
    with pytest.raises(ValueError):
        store.prune(0)


def test_open_store_picks_the_dirs_store(tmp_path, variables):
    """npz files win where both are present (the JAX package's detection);
    a dir of DCP checkpoints alone is the orbax store; an empty dir is an
    npz store."""
    assert type(tckpt.open_store(str(tmp_path / "empty"))) is tckpt.CheckpointStore
    OrbaxCheckpointStore(str(tmp_path), async_save=False).save(variables, 12, suffix="0.8")
    store = tckpt.open_store(str(tmp_path))
    assert isinstance(store, OrbaxCheckpointStore) and store.load(cfg=CFG)[1] == 12
    tckpt.CheckpointStore(str(tmp_path)).save(variables, 3)
    store = tckpt.open_store(str(tmp_path))
    assert type(store) is tckpt.CheckpointStore and [s for s, _, _ in store.list_checkpoints()] == [3]


@pytest.fixture(scope="module")
def jax_orbax_dir(tmp_path_factory):
    """A model dir with one checkpoint of the JAX package's orbax store."""
    from roomnet_tpu.models.roomnet import init_variables as jax_init

    d = tmp_path_factory.mktemp("jax_orbax")
    JaxOrbaxStore(str(d), async_save=False).save(jax_init(jax.random.PRNGKey(0), TINY), 7, suffix="0.6")
    return d


def test_jax_written_orbax_directories_are_refused_by_name(jax_orbax_dir):
    path = str(jax_orbax_dir / "roomnet--0.6--7")
    assert orbax_io.is_jax_orbax_dir(path) and orbax_io.jax_orbax_dirs(str(jax_orbax_dir)) == [path]
    for make in (lambda: OrbaxCheckpointStore(str(jax_orbax_dir)), lambda: tckpt.open_store(str(jax_orbax_dir))):
        with pytest.raises(orbax_io.JaxOrbaxCheckpoint, match="roomnet--0.6--7") as e:
            make()
        assert "roomnet_tpu.params.orbax_io.OrbaxCheckpointStore" in str(e.value)  # how to convert


def test_jax_written_orbax_directory_is_refused_at_load(jax_orbax_dir, tmp_path, variables):
    """Loading a JAX-written directory by path from a store of the port's."""
    store = OrbaxCheckpointStore(str(tmp_path), async_save=False)
    with pytest.raises(orbax_io.JaxOrbaxCheckpoint, match="roomnet--0.6--7"):
        store.load(str(jax_orbax_dir / "roomnet--0.6--7"), cfg=CFG)
