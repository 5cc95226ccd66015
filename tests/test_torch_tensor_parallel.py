"""Tensor parallelism over the mesh's 'model' axis in the port's training
step (roomnet_tpu_torch/parallel/tensor.py, the `tp` argument of
models/roomnet.py:forward and train/step.py) against roomnet_tpu's, on the
CPU: ranks over gloo (tests/torch_dp_worker.py) on (1, 2) and (2, 2)
meshes against the JAX step jitted over the same mesh shape with
`variables_shardings(..., tensor_parallel=True)`, as
tests/test_sharding.py:test_dp_tp_train_step_matches_single_device places
it, on the conftest's 8 virtual CPU devices.

Two configs: TINY (tests/tiny.py), where only the dense kernels are split,
and FIVE, five blocks whose blocks/3 conv (16 channels) is split too and
runs column-parallel. Tolerances are tests/test_torch_parallel.py's: the
whole state (every rank's slices gathered) within TOL of JAX's, the Adam
moments within MOMENT_SHARE of each tensor's largest magnitude, the loss
metric within TOL. Dropout is held against the port's world of one, whose
masks are the mesh's (its bits cannot match JAX's).

Planted faults (tests/torch_dp_worker.py:FAULTS, planted in the ranks'
processes alone, on the (1, 2) mesh) must fail those checks: the gather's
backward summing over 'model', no dgrad all-reduce (copy_to_model's
backward left out), the gradient all-reduce over the world instead of the
data group, and the loss metric with the L2 of this rank's slices alone.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from roomnet_tpu.models import roomnet as JM
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.parallel import mesh as jmesh
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.train import step as JS
from roomnet_tpu.train.optimizer import flatten_opt_state as jax_flatten_opt
from roomnet_tpu_torch.models import roomnet as TM
from roomnet_tpu_torch.parallel import mesh as tmesh
from roomnet_tpu_torch.parallel import tensor as PT
from roomnet_tpu_torch.params.schema import flatten_tensors, variables_from_numpy
from tests import torch_dp_worker as W
from tests.test_torch_parallel import MOMENT_SHARE, TOL, _check
from tests.tiny import TINY

STEPS = 2
HP = dict(learn_rate=1e-3, num_steps=1000, l2_coeff=6e-2)
BN_HP = dict(HP, compute_bn_mean_var=True, update_bn_moving=True)
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)  # on (2, 2): 4 real rows on data rank 0, 1 on data rank 1
CASES = {"infbn": dict(hp_kw=HP), "trainbn": dict(hp_kw=BN_HP), "masked": dict(hp_kw=HP, mask=MASK),
         "dropout": dict(hp_kw=dict(HP, dropout_enabled=True, dropout_rate=0.3))}
JAX_CASES = ("infbn", "trainbn", "masked")
TINY_KW = dict(num_classes=4, im_side=32, block_filters=(8, 16), block_depths=(1, 2),
               block_pools=((3, 1), (4, 2)), dense_units=(16, 8))
# 64 -> B1 conv 62, pool3/s1 60 | B2 conv 58, pool4/s2 28, conv 26, pool 12 | B3 conv 10 | B4 conv 8 (16
# channels, split over 'model') | B5 conv 6, conv 4, residual 6 -> 4 | flatten 4*4*8 = 128.
FIVE_KW = dict(num_classes=4, im_side=64, block_filters=(4, 8, 8, 16, 8), block_depths=(1, 2, 1, 1, 2),
               block_pools=((3, 1), (4, 2), None, None, None), dense_units=(16, 8))
CONFIGS = {"tiny": TINY_KW, "five": FIVE_KW}
MESHES = ((1, 2), (2, 2))
FAULT_RUNS = [("gather_backward_sums", "tiny/infbn"), ("no_copy_to_model", "five/infbn"),
              ("grads_over_world", "tiny/infbn"), ("l2_metric_local_slices", "tiny/infbn")]


def _inputs(cfg_kw, key, seed):
    """The JAX init from PRNGKey(key) with random BN fields and a batch of 8
    from RandomState(seed), as tests/test_torch_parallel.py makes them (and
    for TINY the same arrays)."""
    rng = np.random.RandomState(seed)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(key), JM.RoomNetConfig(**cfg_kw)))
    for k in flat:
        if "bn/" in k:
            n = flat[k].shape
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1, "mean": rng.randn(*n) * 0.1,
                       "var": rng.rand(*n) + 0.5}[k.rsplit("/", 1)[1]].astype(np.float32)
    side = cfg_kw["im_side"]
    x = rng.randint(0, 256, (8, side, side, 3)).astype(np.uint8)
    y = rng.randint(0, cfg_kw["num_classes"], (8,)).astype(np.int32)
    return flat, x, y


@pytest.fixture(scope="module")
def inputs():
    return {"tiny": _inputs(TINY_KW, 3, 0), "five": _inputs(FIVE_KW, 4, 4)}


def _runs(inputs) -> dict:
    runs = {}
    for name, kw in CONFIGS.items():
        flat, x, y = inputs[name]
        for case, c in CASES.items():
            runs[f"{name}/{case}"] = dict(flat=flat, x=x, y=y, cfg_kw=kw, steps=STEPS, **c)
    return runs


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """{(n_data, n_model): every rank's results}; the faults and the
    collectives' gradients on (1, 2)."""
    rng = np.random.RandomState(5)
    grads = dict(x=rng.randn(4, 6, 5).astype(np.float32), w=rng.randn(4, 6, 5).astype(np.float32), axis=1,
                 v=rng.randn(3, 6).astype(np.float32), k=rng.randn(6, 8).astype(np.float32))
    out = {}
    for n_data, n_model in MESHES:
        first = (n_data, n_model) == (1, 2)
        out[(n_data, n_model)] = W.spawn(
            "tp_steps", n_data * n_model, tmp_path_factory.mktemp(f"tp_{n_data}x{n_model}"), n_model=n_model,
            runs=_runs(inputs), faults=FAULT_RUNS if first else (), grads=grads if first else None)
    out["grads"] = grads
    return out


_jax_cache: dict = {}


def _jax_tp_steps(inputs, name, case, n_data, n_model) -> dict:
    """The JAX step jitted over make_mesh(n_data, n_model): train vars placed
    by variables_shardings(..., tensor_parallel=True), frozen vars and the
    optimizer state replicated, the batch (and mask) on 'data'
    (tests/test_sharding.py), `STEPS` times on the same batch."""
    key = (name, case, n_data, n_model)
    if key in _jax_cache:
        return _jax_cache[key]
    flat, x, y = inputs[name]
    cfg = JM.RoomNetConfig(**CONFIGS[name])
    c = CASES[case]
    hp = JS.TrainHParams(**c["hp_kw"])
    mesh = jmesh.make_mesh(n_data, n_model)
    data, repl = NamedSharding(mesh, JP("data")), NamedSharding(mesh, JP())
    state = JS.init_train_state(jschema.unflatten_variables(flat, cfg), hp)
    tp = jmesh.variables_shardings(state.train_vars.keys(), mesh, tensor_parallel=True)
    state = state._replace(
        train_vars={k: jax.device_put(v, tp[k]) for k, v in state.train_vars.items()},
        frozen_vars={k: jax.device_put(v, repl) for k, v in state.frozen_vars.items()},
        opt_state=jax.tree_util.tree_map(lambda v: jax.device_put(v, repl), state.opt_state))
    step = jax.jit(JS.make_train_step(hp, cfg))
    args = [jax.device_put(x, data), jax.device_put(y, data), jax.random.PRNGKey(0)]
    if "mask" in c:
        args.append(jax.device_put(c["mask"], data))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, *args)
        losses.append(float(metrics["loss"]))
    out = {"meta/step": np.asarray(state.step), **jax.device_get(state.train_vars),
           **jax.device_get(state.frozen_vars)}
    out.update({f"opt/{k}": np.asarray(v) for k, v in jax_flatten_opt(state.opt_state).items()})
    _jax_cache[key] = (out, losses)
    return _jax_cache[key]


def _check_losses(got_metrics, want_losses):
    for m, want in zip(got_metrics, want_losses, strict=True):
        assert abs(m["loss"] - want) <= TOL * (1 + abs(want)), (m["loss"], want)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_the_jax_step_over_the_mesh(ranks, inputs, name, case, mesh):
    """STEPS tensor-parallel steps against the JAX step jitted over the same
    mesh shape: every rank's gathered state within the docstring's
    tolerances of JAX's (the Adam moments by their share under batch
    statistics), the loss metric within TOL, the ranks' states equal."""
    want, losses = _jax_tp_steps(inputs, name, case, *mesh)
    res = ranks[mesh]
    got = res[0][f"{name}/{case}"]
    for other in res[1:]:
        for k, v in got["state"].items():
            np.testing.assert_array_equal(other[f"{name}/{case}"]["state"][k], v, err_msg=k)
    assert int(got["state"]["meta/step"]) == STEPS
    _check(got["state"], want, TOL, MOMENT_SHARE, moments=case == "trainbn")
    _check_losses(got["metrics"], losses)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_only_its_slices(ranks, inputs, name, mesh):
    """Every rank's trainable leaves and Adam moments have the shapes their
    specs give on the mesh: the split axis over n_model, the rest whole."""
    flat, _, _ = inputs[name]
    n_model = mesh[1]
    spec = jmesh.variables_shardings(flat, jmesh.make_mesh(*mesh), tensor_parallel=True)
    for r in ranks[mesh]:
        local = r[f"{name}/infbn"]["local_shapes"]
        for k, shape in local.items():
            path = k.split("/", 2)[2] if k.startswith("opt/") else k
            want = tuple(d // n_model if a == "model" else d
                         for d, a in zip(flat[path].shape, tuple(spec[path].spec) + (None,) * 4))
            assert shape == want, (k, shape, want)
        assert any(s != flat[k].shape for k, s in local.items() if not k.startswith("opt/"))
        if name == "five":
            assert local["blocks/3/conv/0"] == (3, 3, 8, 8)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_dropout_equals_the_world_of_one(ranks, inputs, name, mesh):
    """Dropout: the mesh's gathered state against the port's step on the
    whole batch in one process (no group, no split), the generator seeded
    alike: each data rank keeps its rows of the global batch's masks, and
    the model ranks draw the same. With inference BN: with batch statistics
    too, a data-parallel mesh alone ((4, 1), no split) already sits 5.7e-3
    of the largest Adam moment from one process on FIVE (blocks/0/bn/0's
    beta, a small difference of large sums), the floor of summing the BN
    moments in another order, which "trainbn" holds against JAX."""
    flat, x, y = inputs[name]
    one = W.tp_run(flat, x, y, CONFIGS[name], CASES["dropout"]["hp_kw"], STEPS)
    got = ranks[mesh][0][f"{name}/dropout"]
    _check(got["state"], one["state"], TOL, MOMENT_SHARE, moments=True)
    _check_losses(got["metrics"], [m["loss"] for m in one["metrics"]])


@pytest.mark.parametrize("fault,run", FAULT_RUNS, ids=[f for f, _ in FAULT_RUNS])
def test_planted_faults_fail_the_checks(ranks, inputs, fault, run):
    """Each planted fault fails the check that the unplanted run passes: the
    state against the JAX step on (1, 2), or the loss metric for the L2
    fault (its state is untouched)."""
    name, case = run.split("/")
    want, losses = _jax_tp_steps(inputs, name, case, 1, 2)
    got, clean = ranks[(1, 2)][0][(fault, run)], ranks[(1, 2)][0][run]
    with pytest.raises(AssertionError):
        if fault == "l2_metric_local_slices":
            _check_losses(got["metrics"], losses)
        else:
            _check(got["state"], want, TOL, MOMENT_SHARE, moments=False)
    _check(clean["state"], want, TOL, MOMENT_SHARE, moments=False)
    _check_losses(clean["metrics"], losses)


@pytest.mark.parametrize("which", ["gather", "copy"])
def test_collective_gradients_match_one_process(ranks, which):
    """gather_model's backward is this rank's slice of the incoming
    gradient; copy_to_model's sums every rank's: each against autograd of
    the unsplit function in one process."""
    g = ranks["grads"]
    n = 2
    if which == "gather":
        x = torch.from_numpy(g["x"]).requires_grad_()
        (x * torch.from_numpy(g["w"])).sum().backward()
        c = x.shape[g["axis"]] // n
        for i, r in enumerate(ranks[(1, 2)]):
            want = x.grad.narrow(g["axis"], i * c, c)
            np.testing.assert_array_equal(r["grads"]["gather"], want.numpy())
    else:
        v = torch.from_numpy(g["v"]).requires_grad_()
        (v @ torch.from_numpy(g["k"])).square().sum().backward()
        for r in ranks[(1, 2)]:
            np.testing.assert_allclose(r["grads"]["copy"], v.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_shard_flat_refuses_an_indivisible_axis():
    """At 224, 'model' of 4 does not divide the 6-class head's kernel (nor 2
    the tiny head at 3 classes): shard_flat raises ValueError; 2 divides
    every split axis at 224 (128, 32, 16, 8, 6)."""
    flat = flatten_tensors(TM.init_variables(torch.Generator().manual_seed(0)))
    shardings = tmesh.variables_shardings(flat, None, tensor_parallel=True)
    four = types.SimpleNamespace(shape={"data": 1, "model": 4}, coords=(0, 3))
    with pytest.raises(ValueError, match="dense/3/kernel"):
        PT.shard_flat(flat, shardings, four)
    two = types.SimpleNamespace(shape={"data": 1, "model": 2}, coords=(0, 1))
    local = PT.shard_flat(flat, shardings, two)
    assert local["blocks/3/conv/0"].shape == (3, 3, 64, 64) and local["dense/3/kernel"].shape == (8, 3)
    torch.testing.assert_close(local["blocks/3/conv/0"], flat["blocks/3/conv/0"][..., 64:], rtol=0, atol=0)


def test_forward_refuses_a_split_conv_0():
    """Conv 0 may not be split over 'model': the uint8 fold derives its
    bias from the whole kernel. Other leaves than conv output axes and
    dense kernels have no placement rule."""
    cfg = TM.RoomNetConfig(**TINY_KW)
    variables = variables_from_numpy(jschema.flatten_variables(jax_init(jax.random.PRNGKey(0), TINY)), cfg, "cpu")
    x = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8 fold"):
        TM.forward(variables, x, cfg, tp=PT.TensorParallel({"blocks/0/conv/0": 3}))
    with pytest.raises(ValueError, match="output axis"):
        TM.forward(variables, x, cfg, tp=PT.TensorParallel({"blocks/1/conv/0": 2}))
    with pytest.raises(ValueError, match="output axis"):
        TM.forward(variables, x, cfg, tp=PT.TensorParallel({"blocks/1/bn/0/scale": 0}))
    # No group: the split leaves are whole, and the forward is the plain one.
    want = TM.forward(variables, x, cfg)
    got = TM.forward(variables, x, cfg, tp=PT.TensorParallel({"dense/0/kernel": 1, "blocks/1/conv/1": 3}))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
