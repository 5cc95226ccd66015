"""The port's TF1 checkpoint interop (roomnet_tpu_torch/params/convert_tf.py,
export_tf.py, schema.tf_name_map) against roomnet_tpu's, on the converted
reference weights (artifacts/roomnet_params.npz, 178,062 params): a TF
checkpoint written by either package's exporter reads back through either
package's converter byte for byte (exact equality, no tolerance), with the
reference graph's 79 variable names. Both packages reject the same bad
inputs, and the `convert` and `convert-to-tf` subcommands of both CLIs write
the same files. TensorFlow is an offline dependency: skipped without it.
"""

import json
import os

import jax
import numpy as np
import pytest

from chip_smoke import tiny_config
from roomnet_tpu import cli as jcli
from roomnet_tpu.models.roomnet import DEFAULT_CONFIG as JAX_CFG
from roomnet_tpu.models.roomnet import init_variables
from roomnet_tpu.params import convert_tf as jconvert
from roomnet_tpu.params import export_tf as jexport
from roomnet_tpu.params import schema as jschema
from roomnet_tpu_torch import cli as tcli
from roomnet_tpu_torch.params import convert_tf as tconvert
from roomnet_tpu_torch.params import export_tf as texport
from roomnet_tpu_torch.params import schema as tschema
from tests.tiny import TINY

tf = pytest.importorskip("tensorflow")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "artifacts", "roomnet_params.npz")


@pytest.fixture(scope="module")
def flat():
    with np.load(NPZ) as data:
        return dict(data)


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_tf_name_map_is_the_jax_packages():
    assert tschema.tf_name_map() == jschema.tf_name_map(JAX_CFG)
    assert tschema.tf_name_map(tiny_config()) == jschema.tf_name_map(TINY)
    assert len(tschema.tf_name_map()) == 79


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_checkpoints_round_trip_byte_exactly(flat, tmp_path, writer, reader):
    export = {"port": texport.export_tf_checkpoint, "jax": jexport.export_tf_checkpoint}[writer]
    convert = {"port": tconvert.convert_tf_checkpoint, "jax": jconvert.convert_tf_checkpoint}[reader]
    path = export(flat, str(tmp_path / "export" / "roomnet"))
    shape_map = tf.train.load_checkpoint(path).get_variable_to_shape_map()
    assert sorted(shape_map) == sorted(tschema.tf_name_map().values())
    assert_same(convert(path), flat)


def test_export_rejects_incomplete_params(flat, tmp_path):
    partial = dict(flat)
    partial.pop("dense/3/bias")
    for export in (texport.export_tf_checkpoint, jexport.export_tf_checkpoint):
        with pytest.raises(KeyError, match="dense/3/bias"):
            export(partial, str(tmp_path / "x" / "roomnet"))


def test_convert_rejects_a_wrong_parameter_count(flat, tmp_path):
    """A checkpoint whose head has 7 classes has every name of the map, and
    1 parameter too many for roomnet-224: the port raises ValueError (the
    JAX package an AssertionError)."""
    wide = dict(flat)
    wide["dense/3/kernel"] = np.zeros((8, 7), np.float32)
    wide["dense/3/bias"] = np.zeros(7, np.float32)
    path = texport.export_tf_checkpoint(wide, str(tmp_path / "wide" / "roomnet"))
    with pytest.raises(ValueError, match="expected 178062 params for this config, got 178071"):
        tconvert.convert_tf_checkpoint(path)
    with pytest.raises(AssertionError, match="expected 178062 params"):
        jconvert.convert_tf_checkpoint(path)


def test_convert_rejects_a_checkpoint_of_another_geometry(flat, tmp_path):
    """A tiny-geometry checkpoint lacks most of roomnet-224's names."""
    tiny = jschema.flatten_variables(init_variables(jax.random.PRNGKey(0), TINY))
    path = jexport.export_tf_checkpoint(tiny, str(tmp_path / "tiny" / "roomnet"), TINY)
    for convert in (tconvert.convert_tf_checkpoint, jconvert.convert_tf_checkpoint):
        with pytest.raises(KeyError, match="TF checkpoint missing variables"):
            convert(path)


def test_convert_clis_write_the_jax_clis_files(flat, tmp_path, capsys):
    """convert-to-tf, then convert, through both CLIs in-process: the same
    npz tensors (byte-exact) and the same manifest, and the checkpoint step
    and optimizer keys of a checkpoint npz left out of the export."""
    src = str(tmp_path / "ckpt.npz")
    np.savez(src, **flat, **{"meta/step": np.asarray(7), "opt/count": np.asarray(3)})

    def run_jax(argv):
        args = jcli.build_parser().parse_args(argv)
        return args.fn(args)

    for name, main in (("jax", run_jax), ("port", tcli.main)):
        prefix, out = str(tmp_path / name / "tf" / "roomnet"), str(tmp_path / name / "params.npz")
        main(["convert-to-tf", "--params", src, "--out", prefix])
        assert f"exported {len(flat)} tensors" in capsys.readouterr().out
        main(["convert", "--tf-ckpt", prefix, "--out", out])
        assert f"converted {len(flat)} tensors -> {out}" in capsys.readouterr().out
    for name in ("jax", "port"):
        with np.load(str(tmp_path / name / "params.npz")) as data:
            assert_same(dict(data), flat)
    manifests = [json.load(open(tmp_path / name / "params.json")) for name in ("jax", "port")]
    assert manifests[0].pop("source_tf_ckpt").startswith(str(tmp_path / "jax"))
    assert manifests[1].pop("source_tf_ckpt").startswith(str(tmp_path / "port"))
    assert manifests[0] == manifests[1] and manifests[1]["num_params"] == 178_062
