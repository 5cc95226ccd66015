"""The port's TFLite and SavedModel export (roomnet_tpu_torch/params/export.py)
against roomnet_tpu's, on tests/tiny.py's geometry with random BN statistics.

Float TFLite: the port's flatbuffer and the JAX export's, run by the TFLite
interpreter on the same inputs, within TOL = 1e-5 of each other, and the
port's within TOL of its own plain forward on the CPU (softmax of
`models/roomnet.forward`); builtins only (no Flex, no XlaCallModule). The
quantized variants convert builtins-only, shrink the file, keep float I/O
and track the float model within the JAX test's coarse gate (0.35,
tests/test_export.py). The SavedModel serves batches 1 and 3 within TOL of
the JAX forward's softmax, class_id its argmax. TensorFlow is an offline
dependency: skipped without it.
"""

import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import tiny_config
from roomnet_tpu.models.roomnet import forward as jax_forward
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import export as jexport
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch.models import roomnet as M
from roomnet_tpu_torch.params import export as texport
from roomnet_tpu_torch.params import schema as tschema
from tests.tiny import TINY

tf = pytest.importorskip("tensorflow")
TOL = 1e-5
QUANT_GATE = 0.35


@pytest.fixture(scope="module")
def trees():
    """(JAX tree, port tree) of one flat dict: init_variables(PRNGKey(5),
    TINY) with random BN statistics."""
    rng = np.random.RandomState(5)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(5), TINY))
    for k in flat:
        if "bn/" in k:
            n, field = flat[k].shape, k.rsplit("/", 1)[1]
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1,
                       "mean": rng.randn(*n) * 0.1, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    return jschema.unflatten_variables(flat, TINY), tschema.variables_from_numpy(flat, tiny_config(), "cpu")


@pytest.fixture(scope="module")
def exported(trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("tflite")
    return {"port": texport.export_tflite(trees[1], str(d / "port.tflite"), tiny_config()),
            "jax": jexport.export_tflite(trees[0], str(d / "jax.tflite"), TINY)}


def run_tflite(path: str, x: np.ndarray) -> np.ndarray:
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    inp, out = interp.get_input_details()[0], interp.get_output_details()[0]
    assert list(inp["shape"]) == [1, TINY.im_side, TINY.im_side, 3]
    assert inp["dtype"] == np.float32 and out["dtype"] == np.float32
    interp.set_tensor(inp["index"], x)
    interp.invoke()
    return interp.get_tensor(out["index"])


def inputs(seed: int, n: int, batch: int = 1):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (batch, TINY.im_side, TINY.im_side, 3)).astype(np.float32) for _ in range(n)]


def test_float_tflite_matches_the_jax_export_and_the_plain_forward(trees, exported):
    for x in inputs(0, 4):
        got, want = run_tflite(exported["port"], x), run_tflite(exported["jax"], x)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        plain = torch.softmax(M.forward(trees[1], torch.from_numpy(x), tiny_config()), -1).numpy()
        np.testing.assert_allclose(got, plain, rtol=0, atol=TOL)
        assert got.argmax() == want.argmax() == plain.argmax()


def test_tflite_ops_are_builtins_only(exported):
    blob = open(exported["port"], "rb").read()
    assert b"Flex" not in blob and b"XlaCallModule" not in blob


@pytest.mark.parametrize("quantize", ["dynamic", "int8"])
def test_quantized_variants_convert_and_track_float(trees, exported, tmp_path, quantize):
    path = texport.export_tflite(trees[1], str(tmp_path / f"{quantize}.tflite"), tiny_config(), quantize=quantize)
    blob = open(path, "rb").read()
    assert b"Flex" not in blob and b"XlaCallModule" not in blob
    assert os.path.getsize(path) < os.path.getsize(exported["port"])
    x = inputs(1, 1)[0]
    assert np.abs(run_tflite(path, x) - run_tflite(exported["port"], x)).max() < QUANT_GATE


def test_unknown_quantize_is_refused(trees, tmp_path):
    with pytest.raises(ValueError, match="quantize"):
        texport.export_tflite(trees[1], str(tmp_path / "x.tflite"), tiny_config(), quantize="int4")


# Run in a process of its own: saving a SavedModel needs eager execution, and
# roomnet_tpu's export_tf switches it off for the rest of a process that
# runs it (tests/test_export_tf.py, tests/test_torch_convert_export_tf.py).
SAVED_MODEL_RUN = """
import sys
import numpy as np
import tensorflow as tf
from chip_smoke import tiny_config
from roomnet_tpu_torch.params.export import export_saved_model
from roomnet_tpu_torch.params.schema import variables_from_numpy

work = sys.argv[1]
batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else None
with np.load(work + "/flat.npz") as data:
    flat = dict(data)
d = export_saved_model(variables_from_numpy(flat, tiny_config(), "cpu"), work + "/sm", tiny_config(),
                       batch_size=batch_size)
f = tf.saved_model.load(d).f
out = {"signature": np.array(f.concrete_functions[0].structured_input_signature[0][0].shape.as_list(), object)}
with np.load(work + "/x.npz") as xs:
    for name, x in xs.items():
        got = f(x)
        out[name + "/class_id"], out[name + "/probs"] = got["class_id"].numpy(), got["probs"].numpy()
np.savez(work + "/out.npz", **out)
"""


def saved_model_run(trees, tmp_path, xs: dict, *args: str):
    """SAVED_MODEL_RUN in a subprocess on `xs`; its outputs."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.savez(tmp_path / "flat.npz", **tschema.flatten_variables(trees[1]))
    np.savez(tmp_path / "x.npz", **xs)
    proc = subprocess.run([sys.executable, "-c", SAVED_MODEL_RUN, str(tmp_path), *args], cwd=repo,
                          capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(tmp_path / "out.npz", allow_pickle=True)


def test_saved_model_serves_any_batch(trees, tmp_path):
    """The batch is unknown in the signature (the JAX package's jax2tf shape
    polymorphism; here a reshape to (-1, flat_len)): batches 1 and 3."""
    xs = {"b1": inputs(2, 1, 1)[0], "b3": inputs(3, 1, 3)[0]}
    with saved_model_run(trees, tmp_path, xs) as out:
        assert list(out["signature"]) == [None, TINY.im_side, TINY.im_side, 3]
        for name, x in xs.items():
            want = np.asarray(jax.nn.softmax(jax_forward(trees[0], x, TINY), -1))
            probs, ids = out[name + "/probs"], out[name + "/class_id"]
            assert ids.shape == (x.shape[0],) and probs.shape == (x.shape[0], TINY.num_classes)
            np.testing.assert_allclose(probs, want, rtol=0, atol=TOL)
            np.testing.assert_array_equal(ids, want.argmax(-1))


def test_saved_model_with_a_fixed_batch(trees, tmp_path):
    """batch_size=4 pins the signature's batch, as the JAX export's does; the
    answers are the JAX forward's."""
    xs = {"b4": inputs(4, 1, 4)[0]}
    with saved_model_run(trees, tmp_path, xs, "4") as out:
        assert list(out["signature"]) == [4, TINY.im_side, TINY.im_side, 3]
        want = np.asarray(jax.nn.softmax(jax_forward(trees[0], xs["b4"], TINY), -1))
        np.testing.assert_allclose(out["b4/probs"], want, rtol=0, atol=TOL)
        np.testing.assert_array_equal(out["b4/class_id"], want.argmax(-1))


def test_allow_flex_tflite_matches_the_jax_export(trees, exported, tmp_path):
    """allow_flex=True adds SELECT_TF_OPS to the allowed sets; the graph needs
    none, so both packages' files answer as the builtins-only export."""
    paths = {"port": texport.export_tflite(trees[1], str(tmp_path / "port.tflite"), tiny_config(), allow_flex=True),
             "jax": jexport.export_tflite(trees[0], str(tmp_path / "jax.tflite"), TINY, allow_flex=True)}
    for x in inputs(6, 2):
        got = run_tflite(paths["port"], x)
        np.testing.assert_allclose(got, run_tflite(paths["jax"], x), rtol=0, atol=TOL)
        np.testing.assert_allclose(got, run_tflite(exported["port"], x), rtol=0, atol=TOL)
