"""The port's Trainer against roomnet_tpu's, on the CPU at tests/tiny.py's
geometry with 2 classes and dropout off (dropout bits cannot match JAX's).

One checkpoint written by the JAX package's CheckpointStore (step 0: the JAX
init with random BN fields, a fresh Adam state) starts both Trainers
in their own model dirs over the same list files. Each runs 7 steps with
save_freq=5, in three curricula: inference BN; batch statistics with the
moving update; and a batch-size boundary at step 4 (batch 2 with batch
statistics, then batch 4 with inference BN). The stats entries are equal,
the checkpoint names and `meta/step` are equal, and the step-5 checkpoint
and the state `train()` returns after 7 steps agree within 1e-4 (rtol and
atol) in params, BN moving stats and the Adam count, and in the Adam
moments with inference BN. Then each package resumes the other's step-5
checkpoint for 2 steps, and the two agree the same way.

Under batch statistics the Adam moments are held to MOMENT_SHARE of each
tensor's largest magnitude instead. Their terms, the CE gradients, cancel
there: a BN with batch statistics removes the per-channel mean that the
beta and conv of the layer before it shift, so those gradients are small
differences of large sums, and the rounding of two f32 implementations
that sum in another order survives in them. Measured at the same params
(the JAX Trainer's after one step, tiny, batch 4): the packages' gradients
of blocks/0/bn/0/bias differ by 3.8e-3 of the tensor's largest, while a
1e-6 perturbation of the params moves the port's own by 8e-5. The params,
which Adam moves by m / sqrt(v), stay within 1e-4.

MOMENT_SHARE is about twice the largest gap measured: the moments differ
by up to 2.9e-4 (batch statistics) and 8.7e-4 (batch boundary) of their
largest at step 5, and 2.4e-3 and 8.7e-4 at step 7. A planted fault fails
it: with beta1 off by 0.001 in the port's moment update alone, the moments
differ by 7.0e-3 to 1.1 of their largest in every curriculum, and with
inference BN the params stay within 1e-4, so only the moments show it;
with beta1 off by 0.01, or the moments left unchanged for the third step,
the moments differ by 0.069 to 2.4.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest

from chip_smoke import state_gap, state_tensors, tiny_config
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.params.checkpoint import CheckpointStore as JaxStore
from roomnet_tpu.train import loop as jloop
from roomnet_tpu.train.optimizer import flatten_opt_state as jax_flatten_opt
from roomnet_tpu.train.step import init_train_state as jax_init_state
from roomnet_tpu_torch.train import loop as tloop
from tests.tiny import TINY

cv2 = pytest.importorskip("cv2")
JAX_CFG = dataclasses.replace(TINY, num_classes=2)
PORT_CFG = dataclasses.replace(tiny_config(), num_classes=2)
TOL = 1e-4
MOMENT_SHARE = 5e-3
CURRICULA = {
    "infbn": [dict(until_step=1 << 62, batch_size=4)],
    "trainbn": [dict(until_step=1 << 62, batch_size=4, compute_bn_mean_var=True, update_bn_moving=True)],
    "batch_boundary": [dict(until_step=4, batch_size=2, compute_bn_mean_var=True, update_bn_moving=True),
                       dict(until_step=1 << 62, batch_size=4)],
}


def _config(pkg, root, name, model_dir, curriculum):
    return pkg.TrainConfig(
        data_dir=str(root / "data"), train_list_fpath=str(root / "train_list.txt"),
        val_list_fpath=str(root / "val_list.txt"), stats_fpath=str(root / f"stats_{name}.json"),
        model_dir=str(model_dir), img_side=32, train_steps=1000, save_freq=5, val_batch_size=2, learn_rate=1e-3,
        l2_coeff=6e-2, stall_timeout_s=0, phases=tuple(pkg.Phase(**p) for p in CURRICULA[curriculum]))


def _jax_state(state) -> dict:
    flat = {"meta/step": np.asarray(state.step), **jax.device_get(state.train_vars),
            **jax.device_get(state.frozen_vars)}
    flat.update({f"opt/{k}": np.asarray(v) for k, v in jax_flatten_opt(state.opt_state).items()})
    return flat


def _check(got: dict, want: dict, curriculum: str):
    """`got` within TOL of `want`; under batch statistics the Adam moments
    within MOMENT_SHARE of each tensor's largest magnitude (docstring)."""
    moments = set()
    if curriculum != "infbn":
        moments = {k for k in want if k.startswith(("opt/mu/", "opt/nu/"))}
        for k in moments:
            d = np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            assert d <= MOMENT_SHARE * np.abs(want[k]).max(), (k, d)
    state_gap({k: got[k] for k in got if k not in moments}, {k: want[k] for k in want if k not in moments}, TOL)


def _ckpt(path) -> dict:
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{curriculum: {"jax"/"port": (returned state as {name: array}, model
    dir, stats file)}} of both Trainers' 7-step runs from one JAX checkpoint."""
    root = tmp_path_factory.mktemp("parity")
    rng = np.random.RandomState(0)
    for cls, base in [("Kitchen", 40), ("Bedroom", 200)]:
        d = root / "data" / cls
        d.mkdir(parents=True)
        for i in range(10):
            im = np.clip(rng.randint(base - 30, base + 60, (40, 48, 3)), 0, 255)
            cv2.imwrite(str(d / f"im_{i}.png"), im.astype(np.uint8))
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(5), JAX_CFG))
    # Random BN fields, as a trained model has. With the reference's L2
    # (6e-2), a nonzero beta gives the one tensor whose CE gradient vanishes
    # under batch statistics (the beta of a block's last BN, which the
    # residual's batch-statistics BN follows) an L2 gradient far above the
    # rounding noise of that CE gradient, which Adam would otherwise
    # normalize into a step of random sign.
    for k in flat:
        field = k.rsplit("/", 1)[1]
        if "bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1,
                       "mean": rng.randn(*n) * 0.1, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    variables = jschema.unflatten_variables(flat, JAX_CFG)
    start = JaxStore(str(root / "start")).save(
        variables, 0, opt_state_flat=jax_flatten_opt(jax_init_state(variables).opt_state))
    out = {}
    for curriculum in CURRICULA:
        out[curriculum] = {}
        for name, pkg in (("jax", jloop), ("port", tloop)):
            mdir = root / f"{curriculum}_{name}"
            mdir.mkdir()
            shutil.copy(start, mdir)
            tc = _config(pkg, root, f"{curriculum}_{name}", mdir, curriculum)
            if name == "jax":
                state = _jax_state(jloop.Trainer(tc, JAX_CFG).train(total_steps=7, log_every=100))
            else:
                state = state_tensors(tloop.Trainer(tc, PORT_CFG, device="cpu").train(total_steps=7, log_every=100))
            out[curriculum][name] = (state, mdir, tc.stats_fpath)
    out["root"] = root
    return out


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_stats_entries_and_checkpoint_names_equal_the_jax_trainers(runs, curriculum):
    (_, jdir, jstats), (_, tdir, tstats) = runs[curriculum]["jax"], runs[curriculum]["port"]
    with open(jstats) as f, open(tstats) as g:
        want, got = json.load(f), json.load(g)
    assert [e["step"] for e in got] == [5]
    assert got == want
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sum(n.endswith("--5.npz") for n in os.listdir(tdir)) == 1


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_step5_checkpoint_within_1e4_of_the_jax_trainers(runs, curriculum):
    jdir, tdir = runs[curriculum]["jax"][1], runs[curriculum]["port"][1]
    name = next(n for n in os.listdir(jdir) if n.endswith("--5.npz"))
    want, got = _ckpt(jdir / name), _ckpt(tdir / name)
    assert int(got["meta/step"]) == int(want["meta/step"]) == 5
    assert int(got["opt/count"]) == int(want["opt/count"]) == 5
    _check(got, want, curriculum)
    assert any(not np.array_equal(want[k], _ckpt(jdir / "roomnet--none--0.npz")[k]) for k in want if "/mean" in k) \
        == (curriculum != "infbn")


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_returned_state_within_1e4_of_the_jax_trainers(runs, curriculum):
    want, got = runs[curriculum]["jax"][0], runs[curriculum]["port"][0]
    assert int(got["meta/step"]) == int(want["meta/step"]) == 7
    _check({k: v.numpy() for k, v in got.items()}, want, curriculum)


def test_each_package_resumes_the_others_checkpoint(runs):
    """The port resumes the JAX run's step-5 checkpoint and JAX the port's;
    2 steps on each give the same state (the feeders restart alike)."""
    root = runs["root"]
    ends = {}
    for name, pkg, src in (("port", tloop, "jax"), ("jax", jloop, "port")):
        sdir = runs["infbn"][src][1]
        mdir = root / f"resume_{name}"
        mdir.mkdir()
        shutil.copy(next(sdir / n for n in os.listdir(sdir) if n.endswith("--5.npz")), mdir)
        tc = _config(pkg, root, f"resume_{name}", mdir, "infbn")
        if name == "jax":
            ends[name] = _jax_state(jloop.Trainer(tc, JAX_CFG).train(total_steps=2, log_every=100))
        else:
            ends[name] = state_tensors(tloop.Trainer(tc, PORT_CFG, device="cpu").train(total_steps=2, log_every=100))
    assert int(ends["port"]["meta/step"]) == int(ends["jax"]["meta/step"]) == 7
    state_gap(ends["port"], ends["jax"], TOL)
