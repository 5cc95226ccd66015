"""The port's training step against roomnet_tpu and the TF oracles, on the CPU.

* CE, full loss and CE gradients against tests/golden/grad_golden.npz at
  tests/test_grad_golden.py's gates, tiny and 224, both BN modes (one 224
  case per mode).
* traj_golden.npz's 6 TF1-Adam steps, sequential and multi-step, both
  modes, at tests/test_traj_golden.py's LOSS_ATOL 5e-4 and PARAM_ATOL 1e-4.
* The optimizer at tests/test_optimizer.py's values, and against
  roomnet_tpu's tf1_adam on the same gradients (rtol 1e-5, atol 1e-7).
* bf16: the port's bf16 CE gradients at tiny are no further from the JAX
  f32 gradients than JAX's own bf16 gradients are, plus BF16_GRAD_MARGIN
  of the largest f32 gradient. The margin is what the problem allows: with
  batch statistics over 8 images, noise of 4e-3 on the f32 input (a bf16
  ulp) alone moves the f32 gradients by up to 0.14 at this size, 0.1 of
  the largest.
* tests/test_train_step.py's behaviours, each on the port and where it
  yields a number against roomnet_tpu's: L2 over BN gamma and beta, frozen
  stats, the moving update, the masked BN against the shrunk batch, the
  all-masked no-op, init_train_state's copies.
* init_variables by its bounds and variance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roomnet_tpu.models import roomnet as JM
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.train import optimizer as JO
from roomnet_tpu.train import step as JS
from roomnet_tpu_torch.models import roomnet as TM
from roomnet_tpu_torch.params import schema as tschema
from roomnet_tpu_torch.train import optimizer as TO
from roomnet_tpu_torch.train import step as TS
from tests.conftest import ARTIFACTS, GOLDEN_DIR
from tests.tiny import TINY

T_TINY = TM.RoomNetConfig(**{f.name: getattr(TINY, f.name) for f in dataclasses.fields(TM.RoomNetConfig)
                             if f.name != "compute_dtype"})
GRAD_GATES = {("tiny", "infbn"): (1e-4, 1e-3), ("tiny", "trainbn"): (2e-4, 1e-3),
              ("224", "infbn"): (3e-4, 1e-3), ("224", "trainbn"): (5e-2, 2e-2)}
LOSS_ATOL, PARAM_ATOL = 5e-4, 1e-4
BF16_GRAD_MARGIN = 0.1


@pytest.fixture(scope="module")
def grad_golden():
    return dict(np.load(GOLDEN_DIR / "grad_golden.npz"))


@pytest.fixture(scope="module")
def traj_golden():
    return dict(np.load(GOLDEN_DIR / "traj_golden.npz"))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, size=(8, 32, 32, 3), dtype=np.uint8),
            rng.randint(0, TINY.num_classes, size=(8,)).astype(np.int32))


@pytest.fixture(scope="module")
def tiny_flat():
    """JAX-initialised tiny weights with random BN statistics, as numpy."""
    flat = jschema.flatten_variables(JM.init_variables(jax.random.PRNGKey(1), TINY))
    rng = np.random.RandomState(2)
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = (rng.randn(*flat[k].shape) * 0.3).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = (rng.rand(*flat[k].shape) + 0.5).astype(np.float32)
    return flat


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_state(flat, hp, cfg=T_TINY):
    return TS.init_train_state(tschema.variables_from_numpy(flat, cfg, "cpu"), hp)


def _jax_state(flat, hp):
    return JS.init_train_state(jschema.unflatten_variables(flat, TINY), hp)


@pytest.mark.parametrize("mode", ["infbn", "trainbn"])
@pytest.mark.parametrize("geom", ["tiny", "224"])
def test_loss_and_ce_grads_match_tf(geom, mode, grad_golden):
    if geom == "tiny":
        flat = {k[len("tiny_param/"):]: v for k, v in grad_golden.items() if k.startswith("tiny_param/")}
        cfg, x, y, pre = T_TINY, grad_golden["tiny_x"], grad_golden["tiny_labels"], "tiny_"
    else:
        with np.load(ARTIFACTS / "roomnet_params.npz") as data:
            flat = dict(data)
        cfg, x, y, pre = TM.DEFAULT_CONFIG, grad_golden["x_norm"], grad_golden["labels"], ""
    train_vars, frozen_vars = tschema.partition_flat({k: _t(v) for k, v in flat.items()})
    params = {k: v.clone().requires_grad_() for k, v in train_vars.items()}
    bn_mode = mode == "trainbn"
    ce, _ = TS.loss_fn(params, frozen_vars, _t(x), _t(y), TS.TrainHParams(l2_coeff=0.0, compute_bn_mean_var=bn_mode), cfg)
    grads = torch.autograd.grad(ce, list(params.values()))
    np.testing.assert_allclose(ce.item(), float(grad_golden[f"{pre}ce_{mode}"]), atol=3e-4, rtol=1e-4)
    loss, _ = TS.loss_fn(train_vars, frozen_vars, _t(x), _t(y), TS.TrainHParams(compute_bn_mean_var=bn_mode), cfg)
    np.testing.assert_allclose(loss.item(), float(grad_golden[f"{pre}loss_{mode}"]), atol=3e-4)
    atol, rtol = GRAD_GATES[(geom, mode)]
    bad = {}
    for path, g in zip(params, grads):
        ref = grad_golden[f"{pre}grad_{mode}/{path}"]
        assert g.shape == ref.shape, path
        delta = np.abs(g.numpy() - ref)
        if not (delta <= atol + rtol * np.abs(ref)).all():
            bad[path] = float(delta.max())
    assert not bad, f"CE-gradient mismatch vs the TF oracle [{geom}/{mode}]: {bad}"


@pytest.mark.parametrize("multi", [False, True], ids=["sequential", "multi_step"])
@pytest.mark.parametrize("mode", ["infbn", "trainbn"])
def test_trajectory_tracks_tf(mode, multi, traj_golden):
    flat = {k[len("traj_param/"):]: v for k, v in traj_golden.items() if k.startswith("traj_param/")}
    hp = TS.TrainHParams(learn_rate=float(traj_golden["lr0"]), num_steps=int(traj_golden["sched_steps"]),
                         l2_coeff=float(traj_golden["l2_coeff"]), compute_bn_mean_var=mode == "trainbn")
    state = _port_state(flat, hp)
    x, y = _t(traj_golden["x_uint8_bgr"]), _t(traj_golden["labels"])
    k = int(traj_golden["steps"])
    if multi:
        state, metrics = TS.make_multi_train_step(hp, T_TINY)(state, x.expand(k, *x.shape), y.expand(k, *y.shape))
        np.testing.assert_allclose(metrics["loss"].item(), traj_golden[f"losses_{mode}"][-1], atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(metrics["mean_loss"].item(), traj_golden[f"losses_{mode}"].mean(),
                                   atol=LOSS_ATOL, rtol=0)
    else:
        step, losses = TS.make_train_step(hp, T_TINY), []
        for _ in range(k):
            state, metrics = step(state, x, y)
            losses.append(metrics["loss"].item())
        np.testing.assert_allclose(losses, traj_golden[f"losses_{mode}"], atol=LOSS_ATOL, rtol=0)
    assert int(state.step) == k
    bad = {p: float(np.abs(v.numpy() - traj_golden[f"final_{mode}/{p}"]).max())
           for p, v in state.train_vars.items()}
    assert max(bad.values()) <= PARAM_ATOL, bad


@pytest.mark.parametrize("mode", ["infbn", "trainbn"])
def test_bf16_ce_grads_within_the_jax_bf16_distance(mode, tiny_flat, batch):
    x, y = batch
    bf16 = dataclasses.replace(TINY, compute_dtype=jnp.bfloat16)
    hp = JS.TrainHParams(l2_coeff=0.0, compute_bn_mean_var=mode == "trainbn")
    train_np, frozen_np = jschema.partition_flat(tiny_flat)
    xn = JM.normalize_bgr_uint8(jnp.asarray(x))

    def jgrads(cfg):
        return jax.jit(jax.grad(lambda tv: JS.loss_fn(tv, frozen_np, xn, jnp.asarray(y), hp, cfg, None)[0]))(train_np)

    j32, j16 = jgrads(TINY), jgrads(bf16)
    train_t, frozen_t = tschema.partition_flat({k: _t(v) for k, v in tiny_flat.items()})
    params = {k: v.clone().requires_grad_() for k, v in train_t.items()}
    thp = TS.TrainHParams(l2_coeff=0.0, compute_bn_mean_var=mode == "trainbn")
    ce, _ = TS.loss_fn(params, frozen_t, TM.normalize_bgr_uint8(_t(x)), _t(y), thp,
                       dataclasses.replace(T_TINY, compute_dtype=torch.bfloat16))
    t16 = dict(zip(params, torch.autograd.grad(ce, list(params.values()))))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in j32.values())
    jax_own = max(float(np.abs(np.asarray(j16[k]) - np.asarray(j32[k])).max()) for k in j32)
    port = max(float(np.abs(t16[k].numpy() - np.asarray(j32[k])).max()) for k in j32)
    assert port <= jax_own + BF16_GRAD_MARGIN * scale, (port, jax_own, scale)


def test_l2_covers_bn_scale_and_bias_as_in_roomnet_tpu(tiny_flat, batch):
    x, y = batch
    hp = TS.TrainHParams(l2_coeff=1.0)
    state = _port_state(tiny_flat, hp)
    loss, _ = TS.loss_fn(state.train_vars, state.frozen_vars, TM.normalize_bgr_uint8(_t(x)), _t(y), hp, T_TINY)
    n_bn_scale = sum(v.numel() for k, v in state.train_vars.items() if k.endswith("scale"))
    assert loss.item() > 0.5 * n_bn_scale
    jstate = _jax_state(tiny_flat, JS.TrainHParams(l2_coeff=1.0))
    jloss, _ = JS.loss_fn(jstate.train_vars, jstate.frozen_vars, JM.normalize_bgr_uint8(jnp.asarray(x)),
                          jnp.asarray(y), JS.TrainHParams(l2_coeff=1.0), TINY, None)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


def test_frozen_stats_unchanged_without_the_moving_update(tiny_flat, batch):
    x, y = batch
    state = _port_state(tiny_flat, TS.TrainHParams())
    new, _ = TS.make_train_step(TS.TrainHParams(), T_TINY)(state, _t(x), _t(y))
    for k, v in new.frozen_vars.items():
        torch.testing.assert_close(v, state.frozen_vars[k], rtol=0, atol=0)
    assert any(not torch.equal(v, state.train_vars[k]) for k, v in new.train_vars.items())


def test_moving_update_matches_roomnet_tpu(tiny_flat, batch):
    x, y = batch
    hp = TS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True)
    state, _ = TS.make_train_step(hp, T_TINY)(_port_state(tiny_flat, hp), _t(x), _t(y))
    jhp = JS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True)
    jstate, _ = jax.jit(JS.make_train_step(jhp, TINY))(_jax_state(tiny_flat, jhp), jnp.asarray(x), jnp.asarray(y),
                                                        jax.random.PRNGKey(0))
    for k, v in state.frozen_vars.items():
        assert not np.allclose(v.numpy(), tiny_flat[k]), k
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.frozen_vars[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_update_moving_stats_matches_roomnet_tpu(tiny_flat):
    rng = np.random.RandomState(4)
    paths = ["blocks/0/bn/0", "blocks/1/res_bn", "dense/1/bn"]
    jv = jschema.unflatten_variables(tiny_flat, TINY)
    c = {p: jschema.flatten_variables(jv)[f"{p}/mean"].shape for p in paths}
    stats = {p: [rng.randn(*c[p]).astype(np.float32), rng.rand(*c[p]).astype(np.float32),
                 rng.rand(*c[p]).astype(np.float32)] for p in paths}
    want = jschema.flatten_variables(JM.update_moving_stats(
        jv, {p: JM.B.BNStats(*map(jnp.asarray, s)) for p, s in stats.items()}, 0.99))
    got = tschema.flatten_variables(TM.update_moving_stats(
        tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu"),
        {p: TM.B.BNStats(*map(torch.from_numpy, s)) for p, s in stats.items()}, 0.99))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_masked_bn_matches_the_shrunk_batch(tiny_flat, batch):
    """A batch cycle-padded back to B with its padding masked computes the
    logits, loss, update and moving stats of the shrunk batch of its real
    rows (tolerances of tests/test_train_step.py), and the loss roomnet_tpu
    computes for it."""
    x, y = batch
    n_real = x.shape[0] - 3
    idx = np.concatenate([np.arange(n_real), np.arange(3) % n_real])
    mask = np.ones(x.shape[0], np.float32)
    mask[n_real:] = 0.0
    hp = TS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True)
    step = TS.make_train_step(hp, T_TINY)
    shrunk, m_s = step(_port_state(tiny_flat, hp), _t(x[:n_real]), _t(y[:n_real]))
    masked, m_m = step(_port_state(tiny_flat, hp), _t(x[:n_real][idx]), _t(y[:n_real][idx]), None, _t(mask))
    v = tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu")
    l_s = TM.forward(v, TM.normalize_bgr_uint8(_t(x[:n_real])), T_TINY, use_batch_stats=True)
    l_m = TM.forward(v, TM.normalize_bgr_uint8(_t(x[:n_real][idx])), T_TINY, use_batch_stats=True,
                     batch_row_mask=_t(mask))
    np.testing.assert_allclose(l_m[:n_real].detach().numpy(), l_s.detach().numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(m_m["loss"].item(), m_s["loss"].item(), rtol=1e-5, atol=1e-6)
    for name in ("train_vars", "frozen_vars"):
        for k, a in getattr(shrunk, name).items():
            np.testing.assert_allclose(getattr(masked, name)[k].numpy(), a.numpy(), atol=1e-3, rtol=0, err_msg=k)
    jhp = JS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True)
    _, jm = jax.jit(JS.make_train_step(jhp, TINY))(_jax_state(tiny_flat, jhp), jnp.asarray(x[:n_real][idx]),
                                                    jnp.asarray(y[:n_real][idx]), jax.random.PRNGKey(0),
                                                    jnp.asarray(mask))
    np.testing.assert_allclose(m_m["loss"].item(), float(jm["loss"]), rtol=1e-5)


def test_all_masked_batch_is_a_state_noop(tiny_flat, batch):
    x, y = batch
    hp = TS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True, l2_coeff=6e-2)
    state = _port_state(tiny_flat, hp)
    step = TS.make_train_step(hp, T_TINY)
    new, _ = step(state, _t(x), _t(y), None, torch.zeros(x.shape[0]))
    assert int(new.step) == int(state.step) + 1
    for name in ("train_vars", "frozen_vars"):
        for k, v in getattr(new, name).items():
            torch.testing.assert_close(v, getattr(state, name)[k], rtol=0, atol=0)
    assert int(new.opt_state.count) == int(state.opt_state.count)
    for k in state.opt_state.mu:
        torch.testing.assert_close(new.opt_state.mu[k], state.opt_state.mu[k], rtol=0, atol=0)
        torch.testing.assert_close(new.opt_state.nu[k], state.opt_state.nu[k], rtol=0, atol=0)
    half, _ = step(state, _t(x), _t(y), None, torch.tensor([1.0] * 4 + [0.0] * 4))
    assert any(not torch.equal(v, state.train_vars[k]) for k, v in half.train_vars.items())


def test_init_train_state_copies_the_callers_tensors(tiny_flat, batch):
    x, y = batch
    variables = tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu")
    before = {k: v.clone() for k, v in tschema.flatten_tensors(variables).items()}
    state = TS.init_train_state(variables)
    ptrs = {v.data_ptr() for v in before.values()} | {v.data_ptr() for v in tschema.flatten_tensors(variables).values()}
    assert not ptrs & {v.data_ptr() for d in (state.train_vars, state.frozen_vars) for v in d.values()}
    for _ in range(2):
        state, _ = TS.make_train_step(TS.TrainHParams(), T_TINY)(state, _t(x), _t(y))
    for k, v in tschema.flatten_tensors(variables).items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_multi_step_with_dropout_matches_sequential(tiny_flat, batch):
    """Batch-stat BN, the moving update and dropout on: K steps in one call
    equal K calls fed the same generator."""
    x, y = batch
    hp = TS.TrainHParams(compute_bn_mean_var=True, update_bn_moving=True, dropout_enabled=True, dropout_rate=0.2)
    xk, yk = _t(np.stack([x, x[::-1]])), _t(np.stack([y, y[::-1]]))
    step = TS.make_train_step(hp, T_TINY)
    seq, gen = _port_state(tiny_flat, hp), torch.Generator().manual_seed(11)
    for i in range(2):
        seq, m_seq = step(seq, xk[i], yk[i], gen)
    multi, m_multi = TS.make_multi_train_step(hp, T_TINY)(_port_state(tiny_flat, hp), xk, yk,
                                                          torch.Generator().manual_seed(11))
    assert int(multi.step) == int(seq.step) == 2
    torch.testing.assert_close(m_multi["loss"], m_seq["loss"], rtol=0, atol=0)
    for k, v in seq.train_vars.items():
        torch.testing.assert_close(multi.train_vars[k], v, rtol=0, atol=0)
    a, _ = step(_port_state(tiny_flat, hp), xk[0], yk[0], torch.Generator().manual_seed(11))
    b, _ = step(_port_state(tiny_flat, hp), xk[0], yk[0], torch.Generator().manual_seed(12))
    assert any(not torch.equal(v, b.train_vars[k]) for k, v in a.train_vars.items())


def test_step_marks_forward_then_backward_and_state_variables(tiny_flat, batch):
    x, y = batch
    marks = []
    state, _ = TS.make_train_step(TS.TrainHParams(), T_TINY)(_port_state(tiny_flat, TS.TrainHParams()), _t(x),
                                                              _t(y), mark=marks.append)
    assert marks == ["forward", "backward"]
    flat = tschema.flatten_tensors(state.variables(T_TINY))
    assert flat.keys() == tiny_flat.keys()
    assert all(flat[k] is v for k, v in {**state.train_vars, **state.frozen_vars}.items())


def test_gradients_reach_every_trainable_and_no_moving_stat(tiny_flat, batch):
    x, y = batch
    variables = tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu")
    flat = tschema.flatten_tensors(variables)
    for k, v in flat.items():
        v.requires_grad_(tschema.is_trainable_path(k))
    logits = TM.forward(variables, TM.normalize_bgr_uint8(_t(x)), T_TINY)
    trainable = [v for k, v in flat.items() if tschema.is_trainable_path(k)]
    grads = torch.autograd.grad(logits.sum(), trainable)
    assert all(g.abs().max() > 0 for g in grads)
    assert all(v.grad is None and not v.requires_grad for k, v in flat.items() if not tschema.is_trainable_path(k))


def test_forward_dropout_zero_is_identity_and_batch_stats_change_it(tiny_flat, batch):
    x, _ = batch
    v = tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu")
    xn = TM.normalize_bgr_uint8(_t(x))
    plain = TM.forward(v, xn, T_TINY)
    torch.testing.assert_close(TM.forward(v, xn, T_TINY, dropout_rate=0.0, generator=torch.Generator()), plain,
                               rtol=0, atol=0)
    dropped = TM.forward(v, xn, T_TINY, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(dropped, plain)
    assert not torch.allclose(TM.forward(v, xn, T_TINY, use_batch_stats=True), plain)


def test_schema_partition_matches_roomnet_tpu(tiny_flat):
    t_train, t_frozen = tschema.partition_flat(tiny_flat)
    j_train, j_frozen = jschema.partition_flat(tiny_flat)
    assert list(t_train) == list(j_train) and list(t_frozen) == list(j_frozen)
    v = tschema.variables_from_numpy(tiny_flat, T_TINY, "cpu")
    assert list(tschema.flatten_tensors(v)) == list(jschema.flatten_jax(jschema.unflatten_jax(tiny_flat, TINY)))


# -- optimizer ------------------------------------------------------------------

def test_exponential_decay_values():
    sched = TO.exponential_decay(2e-4, 100_000)
    assert sched(0).item() == np.float32(2e-4)
    np.testing.assert_allclose(sched(100_000).item(), 2e-4 * 0.068, rtol=1e-5)
    np.testing.assert_allclose(sched(50_000).item(), 2e-4 * 0.068 ** 0.5, rtol=1e-5)
    jsched = JO.exponential_decay(2e-4, 100_000)
    for s in (0, 7, 31_000, 100_000):
        np.testing.assert_allclose(sched(s).item(), float(jsched(s)), rtol=1e-6)


def test_tf1_adam_matches_numpy_and_roomnet_tpu():
    """tests/test_optimizer.py's hand-written TF1 Adam, five steps, and the
    JAX package's tf1_adam on the same gradients."""
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    rng = np.random.RandomState(0)
    p0 = rng.randn(7).astype(np.float32)
    grads = [rng.randn(7).astype(np.float32) for _ in range(5)]
    p, m, v = p0.copy(), np.zeros_like(p0), np.zeros_like(p0)
    for t, g in enumerate(grads, start=1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t) * m / (np.sqrt(v) + eps)
    opt, jopt = TO.tf1_adam(lr, b1, b2, eps), JO.tf1_adam(lr, b1, b2, eps)
    params, jparams = {"w": _t(p0)}, {"w": jnp.asarray(p0)}
    state, jstate = opt.init(params), jopt.init(jparams)
    for g in grads:
        upd, state = opt.update({"w": _t(g)}, state)
        params = {"w": params["w"] + upd["w"]}
        jupd, jstate = jopt.update({"w": jnp.asarray(g)}, jstate)
        jparams = {"w": jparams["w"] + jupd["w"]}
    np.testing.assert_allclose(params["w"].numpy(), p, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=1e-5, atol=1e-7)
    assert int(state.count) == 5


def test_tf1_adam_differs_from_torch_adam():
    """eps outside the bias correction: one update of a gradient of 1e-4
    differs from torch.optim.Adam's by more than 1e-3 relative."""
    g = torch.full((3,), 1e-4)
    upd, _ = TO.tf1_adam(1e-3).update({"w": g}, TO.tf1_adam(1e-3).init({"w": torch.zeros(3)}))
    w = torch.zeros(3, requires_grad=True)
    torch_adam = torch.optim.Adam([w], lr=1e-3)
    w.grad = g.clone()
    torch_adam.step()
    assert not torch.allclose(upd["w"], w.detach(), rtol=1e-3)


def test_schedule_clock_is_the_global_step():
    opt = TO.tf1_adam(TO.exponential_decay(2e-4, 100_000))
    g = {"w": torch.ones(3)}
    u0, _ = opt.update(g, opt.init(g), step=torch.tensor(0))
    u_mid, _ = opt.update(g, opt.init(g), step=torch.tensor(50_000))
    np.testing.assert_allclose((u_mid["w"][0] / u0["w"][0]).item(), 0.068 ** 0.5, rtol=1e-4)
    u_fallback, _ = opt.update(g, opt.init(g))
    torch.testing.assert_close(u_fallback["w"], u0["w"], rtol=0, atol=0)


def test_opt_state_flatten_round_trip_and_roomnet_tpu_keys():
    opt = TO.tf1_adam(1e-3)
    params = {"a/b": torch.ones(3), "c": torch.zeros((2, 2))}
    _, state = opt.update(params, opt.init(params))
    flat = TO.flatten_opt_state(state)
    jopt = JO.tf1_adam(1e-3)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    _, jstate = jopt.update(jparams, jopt.init(jparams))
    assert sorted(flat) == sorted(JO.flatten_opt_state(jstate))
    back = TO.unflatten_opt_state({k: np.asarray(v) for k, v in JO.flatten_opt_state(jstate).items()})
    assert int(back.count) == int(state.count) == 1
    for k in params:
        np.testing.assert_allclose(back.mu[k].numpy(), state.mu[k].numpy(), rtol=1e-6)
        np.testing.assert_allclose(back.nu[k].numpy(), state.nu[k].numpy(), rtol=1e-6)
    again = TO.unflatten_opt_state({k: v.numpy() for k, v in flat.items()})
    for k in params:
        torch.testing.assert_close(again.mu[k], state.mu[k], rtol=0, atol=0)


# -- init ---------------------------------------------------------------------

def test_init_variables_glorot_bounds_variance_and_identity_bn():
    cfg = TM.DEFAULT_CONFIG
    v = TM.init_variables(torch.Generator().manual_seed(0), cfg)
    flat = tschema.flatten_tensors(v)
    jflat = jschema.flatten_variables(JM.init_variables(jax.random.PRNGKey(0), JM.DEFAULT_CONFIG))
    assert {k: tuple(t.shape) for k, t in flat.items()} == {k: a.shape for k, a in jflat.items()}
    assert TM.param_count(v) == 178_062
    for k, t in flat.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        if k.endswith(("/conv/0", "/conv/1", "/conv/2", "/kernel")):
            fan = np.prod(t.shape[:-2]) * (t.shape[-2] + t.shape[-1])
            limit = np.sqrt(6.0 / fan)
            assert t.abs().max().item() <= limit
            n = t.numel()
            assert abs(t.var().item() / (limit ** 2 / 3) - 1) <= 5 * np.sqrt(0.8 / n), k
            assert abs(t.mean().item()) <= 5 * limit / np.sqrt(3 * n), k
        else:
            want = 1.0 if k.endswith(("/scale", "/var")) else 0.0
            assert (t == want).all(), k
    again = tschema.flatten_tensors(TM.init_variables(torch.Generator().manual_seed(0), cfg))
    assert all(torch.equal(again[k], t) for k, t in flat.items())
