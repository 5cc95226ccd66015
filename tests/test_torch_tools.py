"""The port's offline tools against the JAX package's: tools/check_tflite_torch.py
against tools/check_tflite.py (the float TFLite export of the converted
weights through each package, scored on the 7-image golden batch: the same
matches, softmax within 1e-5 of each other and 1e-4 of the TF graph), and
tools/bench_fast_decode_torch.py against tools/bench_fast_decode.py (the
native decoder's batches of 8 JPEGs byte-equal, full and DCT-scaled). Each
tool takes its JAX counterpart's flags plus --device where it runs the model
(tools/valset.py has no command line: tools/valset_torch.py's flags are its
own). With jax and roomnet_tpu blocked, the port's bench and the three tools
import and run.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from roomnet_tpu.params import schema as jschema
from roomnet_tpu.params.export import export_tflite as jax_export_tflite
from tools import bench_fast_decode as JFD
from tools import bench_fast_decode_torch as TFD
from tools import check_tflite as JCT
from tools import check_tflite_torch as TCT
from tools import valset_torch as V

cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flags_of(path: str) -> set:
    """The option strings a tool's source names ("--x" literals)."""
    tree = ast.parse(open(path).read())
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("--") and n.value[2:3].isalpha()}


def parser_flags(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("jax_tool,port_tool,extra", [
    ("check_tflite.py", TCT, set()),  # TensorFlow only: it never runs the model on a device
    ("bench_fast_decode.py", TFD, {"--device"}),
])
def test_flags_are_the_jax_tools_plus_device(jax_tool, port_tool, extra):
    assert parser_flags(port_tool.build_parser()) == flags_of(os.path.join(REPO, "tools", jax_tool)) | extra


def test_valset_tool_flags():
    assert parser_flags(V.build_parser()) == {"--device", "--out-dir", "--indices"}
    args = V.build_parser().parse_args([])
    assert (args.device, args.out_dir, args.indices) == (None, None, "undocumented")


def test_check_tflite_model_path_is_positional_as_in_the_jax_tool():
    args = TCT.build_parser().parse_args(["/m.tflite"])
    assert (args.model, args.variants) == ("/m.tflite", False)
    assert TCT.build_parser().parse_args(["--variants"]).variants


@pytest.fixture(scope="module")
def tflite_files(tmp_path_factory):
    pytest.importorskip("tensorflow")
    from roomnet_tpu_torch.params.export import export_tflite
    from roomnet_tpu_torch.params.schema import load_npz

    d = tmp_path_factory.mktemp("tflite")
    with np.load(TCT.PARAMS) as data:
        jvars = jschema.unflatten_variables(dict(data))
    return {"port": export_tflite(load_npz(TCT.PARAMS, device="cpu"), str(d / "port.tflite")),
            "jax": jax_export_tflite(jvars, str(d / "jax.tflite"))}


def test_check_tflite_score_equals_the_jax_tools(tflite_files):
    g = dict(np.load(os.path.join(REPO, "tests", "golden", "forward_golden.npz")))
    port = TCT.score(tflite_files["port"], g)
    jax = JCT.score(tflite_files["jax"], g)
    assert port[:2] == jax[:2] == (7, 7)
    assert abs(port[2] - jax[2]) <= 1e-5 and port[2] < 1e-4
    # One scoring rule: the port's score of the JAX file is the JAX tool's.
    assert TCT.score(tflite_files["jax"], g) == jax


def test_check_tflite_main_passes_on_the_ports_export(tflite_files, capsys):
    TCT.main(tflite_files["port"])
    out = capsys.readouterr().out
    assert "argmax matches: 7/7" in out and out.rstrip().endswith("OK")


def _native_or_skip():
    from roomnet_tpu.data import native as jnative
    from roomnet_tpu_torch.data import native as tnative

    if not (jnative.available() and tnative.available()):
        pytest.skip("the native decoder is not built on this host")


@pytest.mark.parametrize("min_decode_side", [0, 224, 448])
def test_fast_decode_decode_all_equals_the_jax_tools(tmp_path, min_decode_side):
    _native_or_skip()
    from tools.make_synth_dataset import make_image

    rng = np.random.RandomState(0)
    paths = []
    for i in range(8):
        p = str(tmp_path / f"img_{i}.jpg")
        cv2.imwrite(p, make_image(i % 6, rng, 960, 1280)[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 88])
        paths.append(p)
    got, ips = TFD.decode_all(paths, 224, min_decode_side)
    want, _ = JFD.decode_all(paths, 224, min_decode_side)
    assert got.shape == (8, 224, 224, 3) and ips > 0
    np.testing.assert_array_equal(got, want)


def test_fast_decode_tool_raises_without_the_native_decoder(monkeypatch):
    from roomnet_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native decoder is not built"):
        TFD.main("cpu")


BLOCKED_RUN = """
import sys
for m in ("jax", "jaxlib", "roomnet_tpu"):
    sys.modules[m] = None
import dataclasses, tempfile
import numpy as np
import torch
import chip_smoke
from roomnet_tpu_torch import bench
from roomnet_tpu_torch.data import native
from roomnet_tpu_torch.models.roomnet import init_variables
from tools import bench_fast_decode_torch, check_tflite_torch, valset_torch

if __name__ == "__main__":
    cfg = dataclasses.replace(chip_smoke.tiny_config(), num_classes=6)
    line = bench.run("cpu", cfg=cfg, variables=init_variables(torch.Generator().manual_seed(0), cfg), batch=2,
                     infer_iters=1, latency_calls=1, train_batch=2, cap_batch=2, train_iters=1, e2e_images=3,
                     e2e_unique=2, serve_batch=2, serve_pairs=1, burst=2)
    assert line["value"] > 0 and line["extras"]["device"] == "cpu"
    golden = dict(np.load(valset_torch.GOLDEN))
    d = tempfile.mkdtemp()
    paths = valset_torch.build(d, [0, 1], workers=2)
    valset_torch.check_guards(paths, golden)
    px = valset_torch.decode_cv2([paths[0], paths[1]])
    assert px.shape == (2, 224, 224, 3)
    if native.available():
        batch, _ = bench_fast_decode_torch.decode_all([paths[0], paths[1]], 224, 448)
        assert batch.shape == (2, 224, 224, 3)
    assert check_tflite_torch.build_parser().parse_args(["--variants"]).variants
    bad = sorted(n for n in sys.modules if sys.modules[n] is not None
                 and (n in ("jax", "roomnet_tpu") or n.startswith(("jax.", "roomnet_tpu."))))
    assert not bad, bad
    print("ok")
"""


def test_port_tools_import_and_run_with_jax_and_roomnet_tpu_blocked(tmp_path):
    script = tmp_path / "blocked_run.py"
    script.write_text(BLOCKED_RUN)
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
