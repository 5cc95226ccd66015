"""The port's forward against roomnet_tpu and the TF-graph goldens.

Tolerances: against the JAX forward on roomnet-tiny, f32 logits at atol
1e-5 and bf16 argmax exact (the top-2 margins of this input are > 0.5,
bf16 moves logits by ~0.02); against the TF graph, the JAX package's own
gates (tests/test_forward_golden.py): f32 logits and softmax <= 1e-4 with
argmax exact, bf16 argmax exact and |dlogit| < 0.15 on the 7-image batch.
The bf16 distance from the TF graph on each golden batch is at most the JAX
bf16 forward's own plus chip_smoke.BF16_MARGIN (0.01), and the JAX distance
pinned in chip_smoke.py is the measured one to within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from roomnet_tpu.models import registry as jreg
from roomnet_tpu.models import roomnet as JM
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.entry import entry
from roomnet_tpu_torch.infer.classify import RoomNetClassifier
from roomnet_tpu_torch.models import registry as treg
from roomnet_tpu_torch.models import roomnet as TM
from roomnet_tpu_torch.params import schema as tschema
from tests.conftest import ARTIFACTS, GOLDEN_DIR

NPZ = ARTIFACTS / "roomnet_params.npz"


@pytest.fixture(scope="module")
def flat():
    with np.load(NPZ) as data:
        return dict(data)


@pytest.fixture(scope="module")
def port_vars(flat):
    return tschema.variables_from_numpy(flat, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """roomnet-tiny in both packages, JAX-initialised weights with random BN
    statistics, carried across by variables_from_numpy."""
    jcfg, tcfg = jreg.get("roomnet-tiny"), treg.get("roomnet-tiny")
    rng = np.random.RandomState(0)
    flat = jschema.flatten_variables(JM.init_variables(jax.random.PRNGKey(0), jcfg))
    for k in flat:
        if "bn/" in k:  # blocks/*/bn/*, blocks/*/res_bn, dense/*/bn
            n, field = flat[k].shape, k.rsplit("/", 1)[1]
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.5,
                       "mean": rng.randn(*n) * 0.3, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    x_u8 = rng.randint(0, 256, size=(16, 32, 32, 3)).astype(np.uint8)
    return {"jcfg": jcfg, "tcfg": tcfg, "jv": jschema.unflatten_variables(flat, jcfg),
            "tv": tschema.variables_from_numpy(flat, tcfg, "cpu"), "x_u8": x_u8}


@pytest.mark.parametrize("input_kind", ["float", "uint8"])
def test_tiny_forward_f32_matches_roomnet_tpu(tiny, input_kind):
    x = tiny["x_u8"]
    if input_kind == "float":
        x = np.asarray(JM.normalize_bgr_uint8(x))
    want = np.asarray(JM.forward(tiny["jv"], x, tiny["jcfg"]))
    got = TM.forward(tiny["tv"], torch.from_numpy(x), tiny["tcfg"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("input_kind", ["float", "uint8"])
def test_tiny_forward_bf16_argmax_matches_roomnet_tpu(tiny, input_kind):
    x = tiny["x_u8"]
    if input_kind == "float":
        x = np.asarray(JM.normalize_bgr_uint8(x))
    jcfg = dataclasses.replace(tiny["jcfg"], compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tiny["tcfg"], compute_dtype=torch.bfloat16)
    want = np.asarray(JM.forward(tiny["jv"], x, jcfg))
    got = TM.forward(tiny["tv"], torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() < 0.1


def test_tiny_normalize_matches_roomnet_tpu(tiny):
    want = np.asarray(JM.normalize_bgr_uint8(tiny["x_u8"]))
    got = TM.normalize_bgr_uint8(torch.from_numpy(tiny["x_u8"])).numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_golden_f32(forward_golden, port_vars):
    x = TM.normalize_bgr_uint8(torch.from_numpy(forward_golden["x_uint8_bgr"]))
    ids, probs = TM.predict(port_vars, x)
    logits = TM.forward(port_vars, x).numpy()
    np.testing.assert_allclose(logits, forward_golden["logits"], atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), forward_golden["softmax"], atol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), forward_golden["argmax"])
    assert logits.min() >= 0.0 and logits.max() <= 6.0  # ReLU6-clipped logits


def test_forward_golden_uint8_fold_f32(forward_golden, port_vars):
    logits = TM.forward(port_vars, torch.from_numpy(forward_golden["x_uint8_bgr"])).numpy()
    np.testing.assert_allclose(logits, forward_golden["logits"], atol=1e-4)


def test_forward_golden_bf16(forward_golden, port_vars):
    x = TM.normalize_bgr_uint8(torch.from_numpy(forward_golden["x_uint8_bgr"]))
    logits = TM.forward(port_vars, x, TM.FAST_CONFIG).numpy()
    np.testing.assert_array_equal(logits.argmax(-1), forward_golden["argmax"])
    assert np.abs(logits - forward_golden["logits"]).max() < 0.15


@pytest.mark.parametrize("cfg_name", ["roomnet-224", "roomnet-224-bf16"])
def test_forward_golden_wide(port_vars, cfg_name):
    g = dict(np.load(GOLDEN_DIR / "forward_golden_wide.npz"))
    x = TM.normalize_bgr_uint8(torch.from_numpy(g["x_uint8_bgr"]))
    logits = TM.forward(port_vars, x, treg.get(cfg_name)).numpy()
    np.testing.assert_array_equal(logits.argmax(-1), g["argmax"])
    if cfg_name == "roomnet-224":
        np.testing.assert_allclose(logits, g["logits"], atol=1e-4)


@pytest.mark.parametrize("label", sorted(chip_smoke.JAX_BF16_DLOGIT))
def test_bf16_distance_from_tf_within_roomnet_tpu(flat, port_vars, label):
    """chip_smoke.py holds the card's bf16 forward to the JAX package's bf16
    distance from the TF graph, pinned there because the card has no JAX.
    Here the pin is checked against the JAX forward, and the port against it."""
    g = dict(np.load(GOLDEN_DIR / f"{label}.npz"))
    x = g["x_uint8_bgr"]
    jax_fwd = jax.jit(lambda v, x: JM.forward(v, JM.normalize_bgr_uint8(x), JM.FAST_CONFIG))
    jax_logits = jax_fwd(jschema.unflatten_variables(flat), x)
    jax_d = np.abs(np.asarray(jax_logits) - g["logits"]).max()
    port_logits = TM.forward(port_vars, TM.normalize_bgr_uint8(torch.from_numpy(x)), TM.FAST_CONFIG)
    port_d = np.abs(port_logits.numpy() - g["logits"]).max()
    assert abs(jax_d - chip_smoke.JAX_BF16_DLOGIT[label]) < 1e-4
    assert port_d <= jax_d + chip_smoke.BF16_MARGIN
    assert chip_smoke.BF16_DLOGIT[label] == max(0.15, chip_smoke.JAX_BF16_DLOGIT[label] + chip_smoke.BF16_MARGIN)


def test_param_count(port_vars):
    assert TM.param_count(port_vars) == 178062


def test_param_count_takes_variables_by_keyword_as_the_jax_function(flat, port_vars):
    jax_vars = jschema.unflatten_variables(flat)
    assert TM.param_count(variables=port_vars) == JM.param_count(variables=jax_vars) == 178062


def test_npz_round_trip_is_bit_identical(flat, port_vars):
    back = tschema.flatten_variables(port_vars)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_variables_from_jax_pytree_equal_npz_load(flat, port_vars):
    from_jax = tschema.variables_from_numpy(
        jschema.flatten_variables(jschema.unflatten_variables(flat)), device="cpu")
    a, b = tschema.flatten_variables(from_jax), tschema.flatten_variables(port_vars)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_registry_matches_roomnet_tpu():
    # The port's registry also holds ResNet-50 (models/resnet.py), which the
    # JAX package has no counterpart of: its RoomNet entries are the JAX one's.
    roomnet = [n for n in treg.names() if isinstance(treg.get(n), TM.RoomNetConfig)]
    assert roomnet == jreg.names() and set(treg.names()) - set(roomnet) == {"resnet50-tiny", "resnet50-v1.5-224-bf16"}
    for name in roomnet:
        t, j = treg.get(name), jreg.get(name)
        assert t.spatial_sizes() == j.spatial_sizes() and t.flat_len == j.flat_len
        assert t.compute_dtype == (torch.bfloat16 if j.compute_dtype == jnp.bfloat16 else torch.float32)
        assert (t.bn_eps, t.block_pools, t.dense_units) == (j.bn_eps, j.block_pools, j.dense_units)
    assert treg.resolve(300, bf16=True) is treg.get("roomnet-300-bf16")
    assert treg.resolve(256, bf16=False).im_side == 256
    with pytest.raises(ValueError):
        treg.resolve(20, bf16=False)


def test_fold_is_checked_against_the_input_dtype(port_vars):
    folded = TM.fold_variables(port_vars, uint8_input=True)
    with pytest.raises(ValueError, match="uint8_input"):
        TM.forward_folded(folded, torch.zeros(1, 224, 224, 3))


def test_classifier_without_device_raises_on_a_host_without_cuda(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoomNetClassifier(tiny["tv"], tiny["tcfg"], batch_size=4)


def test_classifier_cpu_batches_match_predict(tiny):
    clf = RoomNetClassifier(tiny["tv"], tiny["tcfg"], batch_size=5, device="cpu")
    ids, probs = clf.predict(tiny["x_u8"])
    want_ids, want_probs = TM.predict(
        tiny["tv"], TM.normalize_bgr_uint8(torch.from_numpy(tiny["x_u8"])), tiny["tcfg"])
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_allclose(probs, want_probs.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="uint8"):
        clf.predict(tiny["x_u8"].astype(np.float32))


def test_entry_cpu_runs_the_bf16_serving_call(monkeypatch):
    fn, (variables, x) = entry(device="cpu")
    assert x.dtype == torch.uint8 and tuple(x.shape) == (8, 224, 224, 3)
    ids, probs = fn(variables, x)
    assert ids.shape == (8,) and torch.allclose(probs.sum(-1), torch.ones(8), atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry()
