"""The port's autograd Functions around its four kernels, and the training
ops of its blocks, against roomnet_tpu on the CPU.

Each Function's gradients are held against `jax.vjp` of the XLA ops the JAX
package's training forward runs for the same function (roomnet_tpu/ops/
blocks.py, ops/resize.py), f32 at rtol 1e-5 and atol 1e-5 (1e-4 for the
conv's sums), with ReLU6 ties planted where the function has a ReLU6: JAX
gives 0.5 at x == 0 and x == 6, and so must the port. Each Function is also
held against autograd through its own plain version, the check
chip_smoke.py phase 7 makes on the card, within chip_smoke.GRAD_RTOL.
`batch_norm_train` is held against JAX with and without row weights, and
dropout by its statistics (JAX's random bits cannot be matched).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from roomnet_tpu.ops import blocks as JB
from roomnet_tpu.ops.resize import resize_bilinear_tf1 as j_resize_tf1
from roomnet_tpu_torch.ops import blocks as TB
from roomnet_tpu_torch.ops.kernels import conv3x3 as KC
from roomnet_tpu_torch.ops.kernels import dense_head as KD
from roomnet_tpu_torch.ops.kernels import pool as KP
from roomnet_tpu_torch.ops.kernels import residual as KR
from tests.torch_port_util import random_bn, wrapper_cases

AUTOGRAD = {KC.conv3x3: KC.conv3x3_autograd, KP.relu6_pool_bn: KP.relu6_pool_bn_autograd,
            KR.residual_bn: KR.residual_bn_autograd, KD.dense_head: KD.dense_head_autograd}


def _leaf(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_()


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _with_ties(rng, shape, scale=4.0):
    """Random f32 around [0, 6] with an eighth of the values exactly 0 or 6."""
    x = (rng.randn(*shape) * scale + 3.0).astype(np.float32)
    tie = rng.rand(*shape)
    x[tie < 1 / 16] = 0.0
    x[tie > 15 / 16] = 6.0
    return x


def test_relu6_gradient_at_ties_is_half_as_in_jax():
    x = np.array([0.0, 6.0, 3.0, -1.0, 7.0], np.float32)
    want = jax.grad(lambda v: JB.relu6(v).sum())(jnp.asarray(x))
    xt = _leaf(x)
    TB.relu6(xt).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), [0.5, 0.5, 1.0, 0.0, 0.0])
    np.testing.assert_array_equal(KP.relu6_grad(torch.from_numpy(x)).numpy(), xt.grad.numpy())


def test_conv3x3_autograd_matches_jax():
    rng = np.random.RandomState(0)
    x, k = rng.randn(2, 9, 11, 8).astype(np.float32), rng.randn(3, 3, 8, 16).astype(np.float32)
    g = rng.randn(2, 7, 9, 16).astype(np.float32)
    _, vjp = jax.vjp(JB.conv2d_valid, jnp.asarray(x), jnp.asarray(k))
    jx, jk = vjp(jnp.asarray(g))
    xt, kt = _leaf(x), _leaf(k)
    tx, tk = torch.autograd.grad(KC.conv3x3_autograd(xt, kt), (xt, kt), torch.from_numpy(g))
    _close(tx, jx, rtol=1e-4, atol=1e-4)
    _close(tk, jk, rtol=1e-4, atol=1e-4)


def test_conv3x3_autograd_bias_gradient_is_the_output_sum():
    rng = np.random.RandomState(1)
    x, k, b = (_leaf(rng.randn(*s)) for s in ((1, 6, 5, 3), (3, 3, 3, 8), (8,)))
    g = torch.from_numpy(rng.randn(1, 4, 3, 8).astype(np.float32))
    (gb,) = torch.autograd.grad(KC.conv3x3_autograd(x, k, b), (b,), g)
    _close(gb, g.sum((0, 1, 2)).numpy())


@pytest.mark.parametrize("ksize,stride", [(3, 1), (4, 1), (4, 2), (1, 1)])
def test_relu6_pool_bn_autograd_matches_jax_with_planted_ties(ksize, stride):
    """Inference-mode BN folded outside the Function: gradients reach x and
    the BN's scale and bias through `bn_fold`, as jax.vjp of relu6 -> pool
    -> batch_norm gives them."""
    rng = np.random.RandomState(ksize * 10 + stride)
    x = _with_ties(rng, (2, 11, 10, 8))
    bn = random_bn(rng, 8)
    ho, wo = (11 - ksize) // stride + 1, (10 - ksize) // stride + 1
    g = rng.randn(2, ho, wo, 8).astype(np.float32)

    def jfn(x, scale, bias):
        h = JB.avg_pool_valid(JB.relu6(x), ksize, stride)
        return JB.batch_norm(h, {**bn, "scale": scale, "bias": bias})

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(bn["scale"]), jnp.asarray(bn["bias"]))
    want = vjp(jnp.asarray(g))
    xt, st, bt = _leaf(x), _leaf(bn["scale"]), _leaf(bn["bias"])
    tbn = {"scale": st, "bias": bt, "mean": torch.from_numpy(bn["mean"]), "var": torch.from_numpy(bn["var"])}
    y = KP.relu6_pool_bn_autograd(xt, *TB.bn_fold(tbn), ksize=ksize, stride=stride)
    got = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)
    assert {0.0, 6.0} <= set(np.unique(x).tolist())


def test_residual_bn_autograd_matches_jax():
    rng = np.random.RandomState(3)
    x, res = rng.randn(2, 4, 5, 16).astype(np.float32), rng.randn(2, 12, 13, 16).astype(np.float32)
    bn = random_bn(rng, 16)
    g = rng.randn(2, 4, 5, 16).astype(np.float32)

    def jfn(x, res, scale, bias):
        return JB.batch_norm(x + j_resize_tf1(res, (4, 5)), {**bn, "scale": scale, "bias": bias})

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, res, bn["scale"], bn["bias"])))
    want = vjp(jnp.asarray(g))
    xt, rt, st, bt = (_leaf(a) for a in (x, res, bn["scale"], bn["bias"]))
    tbn = {"scale": st, "bias": bt, "mean": torch.from_numpy(bn["mean"]), "var": torch.from_numpy(bn["var"])}
    y = KR.residual_bn_autograd(xt, rt, *TB.bn_fold(tbn))
    got = torch.autograd.grad(y, (xt, rt, st, bt), torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)


def test_dense_head_autograd_matches_jax_with_planted_ties():
    """Two layers of 8 -> 6 -> 4, the first with a column of zeros (its
    pre-activation is 0 on every row) and a column that reads a constant
    input feature of 1 with weight 6 (exactly 6 on every row): both ReLU6
    ties take JAX's gradient of 0.5. The probs get no gradient."""
    rng = np.random.RandomState(5)
    x = rng.randn(5, 8).astype(np.float32)
    x[:, 0] = 1.0
    k0, k1 = rng.randn(8, 6).astype(np.float32), rng.randn(6, 4).astype(np.float32)
    k0[:, 0] = 0.0
    k0[:, 1] = 0.0
    k0[0, 1] = 6.0
    bn, bias = random_bn(rng, 6), rng.randn(4).astype(np.float32)
    g = rng.randn(5, 4).astype(np.float32)

    def jfn(x, k0, k1, scale, beta, bias):
        h = JB.batch_norm(JB.relu6(JB.dense(x, k0)), {**bn, "scale": scale, "bias": beta})
        return JB.relu6(JB.dense(h, k1, bias))

    args = (x, k0, k1, bn["scale"], bn["bias"], bias)
    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(a) for a in args]
    xt, k0t, k1t, st, bt, biast = leaves
    tbn = {"scale": st, "bias": bt, "mean": torch.from_numpy(bn["mean"]), "var": torch.from_numpy(bn["var"])}
    packed, widths = KD.pack_head([{"kernel": k0t, "bias": None, "bn": tbn},
                                   {"kernel": k1t, "bias": biast, "bn": None}])
    logits, probs = KD.dense_head_autograd(xt, packed, widths)
    assert not probs.requires_grad
    got = torch.autograd.grad(logits, leaves, torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a, b)
    # The tie columns: 0.5 of what a column inside (0, 6) would get.
    pre = x @ k0
    assert (pre[:, 0] == 0).all() and (pre[:, 1] == 6).all()


@pytest.mark.parametrize("case", range(4), ids=["conv3x3", "relu6_pool_bn", "residual_bn", "dense_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_function_matches_autograd_through_plain(case, dtype):
    """The Function's backward against PyTorch's autograd through the plain
    version, within chip_smoke.GRAD_RTOL * (|ref| + max|ref|)."""
    kern, plain, args, kwargs = wrapper_cases("cpu", dtype)[case]
    leaves = [a.detach().clone().requires_grad_() if isinstance(a, torch.Tensor) else a for a in args]
    grad_of = [a for a in leaves if isinstance(a, torch.Tensor)]
    got, want = AUTOGRAD[kern](*leaves, **kwargs), plain(*leaves, **kwargs)
    if kern is KD.dense_head:
        got, want = got[0], want[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    up = torch.randn(want.shape, generator=torch.Generator().manual_seed(case)).to(want.dtype)
    rtol = chip_smoke.GRAD_RTOL["f32" if dtype == torch.float32 else "bf16"]
    for a, b in zip(torch.autograd.grad(got, grad_of, up), torch.autograd.grad(want, grad_of, up)):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        assert ((a - b).abs() <= rtol * (b.abs() + b.abs().max())).all()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "row_weights"])
def test_batch_norm_train_matches_roomnet_tpu(weighted):
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 5, 6, 3) * 2 + 1).astype(np.float32)
    bn = random_bn(rng, 3)
    rw = np.array([1, 0, 1, 1], np.float32) if weighted else None
    g = rng.randn(4, 5, 6, 3).astype(np.float32)

    def jfn(x, scale, bias):
        return JB.batch_norm_train(x, {**bn, "scale": scale, "bias": bias}, row_weights=None if rw is None
                                   else jnp.asarray(rw))

    jargs = (jnp.asarray(x), jnp.asarray(bn["scale"]), jnp.asarray(bn["bias"]))
    jy, jst = jfn(*jargs)
    _, vjp = jax.vjp(lambda *a: jfn(*a)[0], *jargs)
    want = vjp(jnp.asarray(g))
    xt, st, bt = _leaf(x), _leaf(bn["scale"]), _leaf(bn["bias"])
    ty, tst = TB.batch_norm_train(xt, {**bn, "scale": st, "bias": bt}, row_weights=None if rw is None
                                  else torch.from_numpy(rw))
    _close(ty, jy)
    for field in ("mean", "var", "var_unbiased"):
        _close(getattr(tst, field), getattr(jst, field))
    for a, b in zip(torch.autograd.grad(ty, (xt, st, bt), torch.from_numpy(g)), want):
        _close(a, b, rtol=1e-4, atol=1e-5)


def test_batch_norm_train_with_no_real_row_gives_zero_stats():
    x = torch.from_numpy(np.random.RandomState(8).randn(3, 2, 2, 4).astype(np.float32))
    bn = {k: torch.from_numpy(v) for k, v in random_bn(np.random.RandomState(9), 4).items()}
    _, st = TB.batch_norm_train(x, bn, row_weights=torch.zeros(3))
    assert (st.mean == 0).all() and (st.var == 0).all() and (st.var_unbiased == 0).all()


def test_dropout_keep_rate_scaling_and_seeding():
    x = torch.ones(400_000)
    rate = 0.35
    y = TB.dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    p = kept.float().mean().item()
    assert abs(p - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / x.numel())
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)), rtol=0, atol=0)
    assert abs(y.mean().item() - 1.0) <= 5 * np.sqrt(rate / (1 - rate) / x.numel())
    torch.testing.assert_close(TB.dropout(x, rate, torch.Generator().manual_seed(0)), y, rtol=0, atol=0)
    assert not torch.equal(TB.dropout(x, rate, torch.Generator().manual_seed(1)), y)
    z = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(TB.dropout(z, 0.0, torch.Generator().manual_seed(3)), z, rtol=0, atol=0)


def test_full_f32_turns_tf32_off_and_restores_it():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with TB.full_f32():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
