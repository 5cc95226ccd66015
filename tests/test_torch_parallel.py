"""The port's scale-out layer (roomnet_tpu_torch/parallel/, the group
argument of ops/blocks.py and train/step.py) against roomnet_tpu's, on the
CPU: two ranks over gloo (tests/torch_dp_worker.py) against the JAX step
jitted over `make_mesh(2, 1)` on two of the 8 virtual CPU devices, where XLA
computes the single-device function of the global batch.

Tolerances. BN outputs, moments and the gradient for x: 1e-6 (rtol and
atol), against JAX's batch_norm_train on the whole batch; the gradients for
scale and bias, each a sum over a channel's 120 values summed in another
order, 1e-5. The DP step: params, BN moving
stats and the Adam count within 1e-4, and the Adam moments under batch
statistics within MOMENT_SHARE of each tensor's largest magnitude (the rule
and reason of tests/test_torch_train_loop_parity.py: their CE terms are
small differences of large sums under batch statistics). A world of 2
against a world of 1 with dropout on (the port against itself, the sums in
another order) is held to the same rule: the gaps measured are at most
4.5e-6 (relative, params) and 4.8e-6 (share, moments) in every case but 4
and 1 real rows under batch statistics, where they reach 6.7e-5 and 3.5e-3
after three steps, as large as the JAX comparison's.

Planted faults (tests/torch_dp_worker.py:FAULTS, each planted in the ranks'
processes alone) must fail those checks: BN moments of the rank's rows
alone, DDP's mean over ranks in place of the global-count division (with
unequal real rows: 4 and 1), L2 counted on every rank, and dropout
generators seeded per rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from chip_smoke import state_gap
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.ops import blocks as JB
from roomnet_tpu.parallel import mesh as jmesh
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.train import step as JS
from roomnet_tpu.train.optimizer import flatten_opt_state as jax_flatten_opt
from roomnet_tpu_torch.parallel import distributed
from roomnet_tpu_torch.parallel import mesh as tmesh
from tests import torch_dp_worker as W
from tests.tiny import TINY

TOL = 1e-4
BN_TOL = 1e-6
MOMENT_SHARE = 5e-3
BN_GRAD_TOL = 1e-5
STEPS = 3
HP = dict(learn_rate=1e-3, num_steps=1000, l2_coeff=6e-2)
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)  # 4 real rows on rank 0, 1 on rank 1
CASES = {
    "infbn": dict(hp=HP, steps=STEPS),
    "trainbn": dict(hp=dict(HP, compute_bn_mean_var=True, update_bn_moving=True), steps=STEPS),
    "masked": dict(hp=HP, steps=STEPS, mask=MASK),
    "masked_trainbn": dict(hp=dict(HP, compute_bn_mean_var=True, update_bn_moving=True), steps=STEPS, mask=MASK),
    "dropout": dict(hp=dict(HP, compute_bn_mean_var=True, update_bn_moving=True, dropout_enabled=True,
                            dropout_rate=0.3), steps=STEPS),
}
FAULT_CASES = [("per_rank_bn", "trainbn"), ("mean_over_ranks", "masked"), ("l2_on_every_rank", "infbn"),
               ("per_rank_dropout_seeds", "dropout")]


@pytest.fixture(scope="module")
def inputs():
    return _draw(3, 0)


def _draw(key: int, seed: int):
    """The JAX init from PRNGKey(key) with random BN fields (as a trained
    model has: with a zero beta, the beta whose CE gradient vanishes under
    batch statistics would take Adam steps of rounding noise) and a batch of
    8, both from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(key), TINY))
    for k in flat:
        if "bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1, "mean": rng.randn(*n) * 0.1,
                       "var": rng.rand(*n) + 0.5}[k.rsplit("/", 1)[1]].astype(np.float32)
    x = rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, TINY.num_classes, (8,)).astype(np.int32)
    return flat, x, y


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results of every case and planted fault."""
    flat, x, y = inputs
    return W.spawn("dp_steps", 2, tmp_path_factory.mktemp("dp_steps"), flat=flat, x=x, y=y, cases=CASES,
                   faults=FAULT_CASES)


def _jax_mesh_steps(flat, x, y, case) -> dict:
    """The JAX step jitted over make_mesh(2, 1) as the JAX Trainer jits it
    (batch and mask on 'data'), `steps` times on the same batch."""
    c = CASES[case]
    hp = JS.TrainHParams(**c["hp"])
    mesh = jmesh.make_mesh(2, 1)
    data = NamedSharding(mesh, JP("data"))
    masked = "mask" in c
    step = jax.jit(JS.make_train_step(hp, TINY),
                   in_shardings=(None, data, data, None, data) if masked else (None, data, data, None))
    state = JS.init_train_state(jschema.unflatten_variables(flat, TINY), hp)
    args = [jax.device_put(x, data), jax.device_put(y, data), jax.random.PRNGKey(0)]
    if masked:
        args.append(jax.device_put(c["mask"], data))
    for _ in range(c["steps"]):
        state, _ = step(state, *args)
    out = {"meta/step": np.asarray(state.step), **jax.device_get(state.train_vars),
           **jax.device_get(state.frozen_vars)}
    out.update({f"opt/{k}": np.asarray(v) for k, v in jax_flatten_opt(state.opt_state).items()})
    return out


def _batch_stats(case) -> bool:
    return CASES[case]["hp"].get("compute_bn_mean_var", False)


def _one_rank(inputs, case) -> dict:
    """The port's step in this process with no group, on the whole batch."""
    flat, x, y = inputs
    c = CASES[case]
    return W._steps(flat, x, y, c["hp"], c["steps"], mask=c.get("mask"), group=None, rank=0, world=1)


def _check(got: dict, want: dict, tol: float, share: float, moments: bool):
    """got within tol of want (state_gap); the Adam moments, where
    `moments`, within `share` of each tensor's largest magnitude instead."""
    held = {k for k in want if k.startswith(("opt/mu/", "opt/nu/"))} if moments else set()
    for k in held:
        d = np.abs(np.asarray(got[k], np.float64) - want[k]).max()
        assert d <= share * np.abs(want[k]).max(), (k, d)
    state_gap({k: got[k] for k in got if k not in held}, {k: want[k] for k in want if k not in held}, tol)


@pytest.fixture
def world_of_one():
    yield
    distributed.shutdown()


def test_initialize_noop_without_env(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert distributed.initialize() is False  # torchrun with one process is a single process
    assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_mesh_shape(tmp_path):
    """make_mesh over two ranks: the rank grid, axis names and shape dict of
    JAX's make_mesh(2, 1) / (1, 2), each rank's coordinates and device, and
    a data group that sums over the data axis alone."""
    res = W.spawn("mesh_layout", 2, tmp_path)
    for n_data, n_model in ((2, 1), (1, 2)):
        jm = jmesh.make_mesh(n_data, n_model)
        for rank, r in enumerate(res):
            got = r[(n_data, n_model)]
            assert np.asarray(got["devices"]).shape == jm.devices.shape == (n_data, n_model)
            assert got["devices"] == [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
            assert got["axis_names"] == tuple(jm.axis_names) == ("data", "model")
            assert got["shape"] == dict(jm.shape)
            assert got["coords"] == divmod(rank, n_model) and got["device"] == "cpu"
            assert got["group_size"] == n_data
            assert got["group_sum"] == (3.0 if n_data == 2 else rank + 1.0)
    for r in res:
        assert r[(None, 1)]["shape"] == {"data": 2, "model": 1} and r["global"] == {"data": 2, "model": 1}
        assert r["count"] == 2
    assert [r["index"] for r in res] == [0, 1]


def test_data_only_mesh_without_model_axis(world_of_one):
    """Without a process group make_mesh starts a world of one: the
    counterpart of a JAX mesh over one device, data-only. Its 'model' axis
    has size 1, and its group is the world's, of one rank."""
    import torch.distributed as dist

    mesh = tmesh.make_mesh(devices="cpu")
    jm = jmesh.make_mesh(1, 1)
    assert mesh.devices.shape == jm.devices.shape == (1, 1)
    assert mesh.shape == dict(jm.shape) and mesh.coords == (0, 0) and mesh.device == torch.device("cpu")
    assert distributed.process_count() == 1
    with pytest.raises(ValueError, match="every rank"):
        tmesh.make_mesh(2, 1)
    group = mesh.group("model")
    assert group is dist.group.WORLD and dist.get_world_size(group) == 1 and dist.get_rank(group) == 0


def test_tp_shardings_cover_dense_kernels(world_of_one):
    """variables_shardings: the JAX package's placement of every variable,
    with and without tensor_parallel, and the batch / replicated specs."""
    mesh = tmesh.make_mesh(devices="cpu")
    jm = jmesh.make_mesh(1, 1)
    paths = list(jschema.flatten_variables(jax_init(jax.random.PRNGKey(0), TINY)))
    paths.append("blocks/3/conv/0")  # the 128-channel conv of the 224 model
    for tp in (False, True):
        got = tmesh.variables_shardings(paths, mesh, tensor_parallel=tp)
        want = jmesh.variables_shardings(paths, jm, tensor_parallel=tp)
        assert {k: tuple(v.spec) for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    sh = tmesh.variables_shardings(paths, mesh, tensor_parallel=True)
    assert sh["dense/0/kernel"].spec == tmesh.P(None, "model") and sh["blocks/0/conv/0"].spec == tmesh.P()
    assert tuple(tmesh.batch_sharding(mesh).spec) == tuple(jmesh.batch_sharding(jm).spec) == ("data",)
    assert tuple(tmesh.replicated(mesh).spec) == tuple(jmesh.replicated(jm).spec) == ()


@pytest.mark.parametrize("weighted", [False, True], ids=["all_rows", "row_weights"])
def test_global_bn_moments_match_the_jax_whole_batch(weighted, tmp_path):
    """batch_norm_train on each rank's 3 rows with the data group: its rows
    of y, the moments and, through the differentiable all-reduce, the
    gradients for x, scale and bias equal JAX's batch_norm_train on the 6
    rows (the docstring's tolerances). With row weights the two ranks hold 3
    and 1 real rows."""
    rng = np.random.RandomState(1)
    x = (rng.randn(6, 5, 4, 8) * 2 + 1).astype(np.float32)
    bn = {"scale": (rng.rand(8) + 0.5).astype(np.float32), "bias": rng.randn(8).astype(np.float32),
          "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    g = rng.randn(*x.shape).astype(np.float32)
    res = W.spawn("bn_moments", 2, tmp_path, x=x, bn=bn, weights=w, grad_out=g)

    def f(x, scale, bias):
        return JB.batch_norm_train(x, {**bn, "scale": scale, "bias": bias},
                                   row_weights=None if w is None else jnp.asarray(w))

    (y, st), vjp = jax.vjp(f, x, bn["scale"], bn["bias"])
    dx, ds, db = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, st)))
    np.testing.assert_allclose(np.concatenate([r["y"] for r in res]), y, rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in res]), dx, rtol=BN_TOL, atol=BN_TOL)
    for r in res:
        for name, want in (("mean", st.mean), ("var", st.var), ("var_unbiased", st.var_unbiased)):
            np.testing.assert_allclose(r[name], want, rtol=BN_TOL, atol=BN_TOL, err_msg=name)
        for name, want in (("dscale", ds), ("dbias", db)):
            np.testing.assert_allclose(r[name], want, rtol=BN_GRAD_TOL, atol=BN_GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("case", ["infbn", "trainbn", "masked", "masked_trainbn"])
def test_dp_step_matches_the_jax_step_over_a_mesh(ranks, inputs, case):
    """Three DP steps on two ranks against the JAX step jitted over
    make_mesh(2, 1): both ranks hold the same state, within the docstring's
    tolerances of JAX's; "masked" holds 4 and 1 real rows."""
    flat, x, y = inputs
    want = _jax_mesh_steps(flat, x, y, case)
    for k, v in ranks[0][case]["state"].items():
        np.testing.assert_array_equal(ranks[1][case]["state"][k], v, err_msg=k)
    assert int(ranks[0][case]["state"]["meta/step"]) == STEPS
    _check(ranks[0][case]["state"], want, TOL, MOMENT_SHARE, moments=_batch_stats(case))


def _jax_steps(step, hp, flat, x, y) -> dict:
    """STEPS calls of the jitted JAX `step` on one device from `flat`, the
    same batch and key each step; the state under the checkpoint's names."""
    state = JS.init_train_state(jschema.unflatten_variables(flat, TINY), hp)
    for _ in range(STEPS):
        state, _ = step(state, x, y, jax.random.PRNGKey(0))
    out = {"meta/step": np.asarray(state.step), **jax.device_get(state.train_vars),
           **jax.device_get(state.frozen_vars)}
    out.update({f"opt/{k}": np.asarray(v) for k, v in jax_flatten_opt(state.opt_state).items()})
    return out


def _moment_share(got: dict, want: dict) -> float:
    """The largest |d| of an Adam moment over its tensor's largest |value|."""
    return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max() / np.abs(want[k]).max())
               for k in want if k.startswith(("opt/mu/", "opt/nu/")))


def test_single_process_step_at_the_k0_draw_within_jaxs_own_jump():
    """The draw (PRNGKey(0), RandomState(0)), TINY, three steps with batch
    statistics: the port's step in one process against the JAX step jitted
    on one device. Under batch statistics a rounding-level change decides
    which side of a non-smooth point both packages land on, so the Adam
    moments are held to the larger of MOMENT_SHARE and twice JAX's own
    largest gap when its weights are scaled by 1 + 2e-7 N(0, 1) (six draws,
    RandomState(1000 + i)); params, BN stats and the count within TOL."""
    flat, x, y = _draw(0, 0)
    hp_kw = CASES["trainbn"]["hp"]
    hp = JS.TrainHParams(**hp_kw)
    step = jax.jit(JS.make_train_step(hp, TINY))
    want = _jax_steps(step, hp, flat, x, y)
    jumps = []
    for i in range(6):
        r = np.random.RandomState(1000 + i)
        scaled = {k: (v * (1 + 2e-7 * r.randn(*v.shape))).astype(np.float32) for k, v in flat.items()}
        jumps.append(_moment_share(_jax_steps(step, hp, scaled, x, y), want))
    got = W._steps(flat, x, y, hp_kw, STEPS, group=None, rank=0, world=1)["state"]
    assert int(got["meta/step"]) == STEPS
    _check(got, want, TOL, max(MOMENT_SHARE, 2 * max(jumps)), moments=True)


@pytest.mark.parametrize("case", list(CASES))
def test_world_of_two_equals_world_of_one(ranks, inputs, case):
    """The global batch on one process, no group, against two ranks: the
    same state (the docstring's tolerances) and metrics; dropout included,
    each rank keeping its rows of the global batch's masks."""
    one = _one_rank(inputs, case)
    _check(ranks[0][case]["state"], one["state"], TOL, MOMENT_SHARE, moments=True)
    for a, b in zip(ranks[0][case]["metrics"], one["metrics"]):
        assert a["accuracy"] == b["accuracy"] and a["learn_rate"] == b["learn_rate"]
        assert abs(a["loss"] - b["loss"]) <= TOL * (1 + abs(b["loss"]))


@pytest.mark.parametrize("fault,case", FAULT_CASES, ids=[f for f, _ in FAULT_CASES])
def test_planted_faults_fail_the_checks(ranks, inputs, fault, case):
    """Each planted fault moves the two-rank state beyond the tolerance its
    check holds: the JAX mesh step's for the first three, the world of one
    for the dropout seeds (whose bits cannot match JAX's)."""
    got = ranks[0][(fault, case)]["state"]
    if fault == "per_rank_dropout_seeds":
        want, tol, share = _one_rank(inputs, case)["state"], TOL, MOMENT_SHARE
    else:
        flat, x, y = inputs
        want, tol, share = _jax_mesh_steps(flat, x, y, case), TOL, MOMENT_SHARE
    with pytest.raises(AssertionError):
        _check(got, want, tol, share, moments=_batch_stats(case))
    # The unplanted run of the same case passes that check.
    _check(ranks[0][case]["state"], want, tol, share, moments=_batch_stats(case))

