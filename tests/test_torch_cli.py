"""The port's CLI (roomnet_tpu_torch/cli.py), its profiling registry and
logging, against roomnet_tpu.

The subcommands run with `--device cpu --exact` on a tiny npz (tests/tiny.py's
geometry: both CLIs' `_model_cfg` are pointed at it, since the registry
only resolves the 224-family by side) and must give what the JAX CLI gives
on the same files: the .csv's names and labels equal and confidences within
1e-5, the stats JSON and the eval-ckpts entries equal, the same /classify
answer. `doctor` without a GPU exits 1 with a FAIL line. The spans that
`predict_stream` records are the JAX pipeline's names, with its counts.
"""

import argparse
import ast
import csv
import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from chip_smoke import tiny_config
from roomnet_tpu import cli as jcli
from roomnet_tpu.infer import classify as JC
from roomnet_tpu.infer.server import ClassifierServer as JaxServer
from roomnet_tpu.models.roomnet import init_variables as jax_init
from roomnet_tpu.params import checkpoint as jckpt
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.utils import profiling as jprof
from roomnet_tpu_torch import cli as tcli
from roomnet_tpu_torch.infer import classify as TC
from roomnet_tpu_torch.infer.server import ClassifierServer
from roomnet_tpu_torch.models import registry as treg
from roomnet_tpu_torch.params import schema as tschema
from roomnet_tpu_torch.utils import logging as tlogging
from roomnet_tpu_torch.utils import profiling as tprof
from tests.tiny import TINY
from torch_port_util import LABELS4, img_bytes, post

cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The CLI classifies into CLASS_LABELS' six classes.
TINY6 = dataclasses.replace(TINY, num_classes=6)
CFG6 = dataclasses.replace(tiny_config(), num_classes=6)
SUBCOMMANDS = {
    "train": ["train"],
    "infer": ["infer", "--images-dir", "/x"],
    "validate": ["validate", "--list-file", "/x"],
    "eval-ckpts": ["eval-ckpts", "--model-dir", "/m", "--list-file", "/x"],
    "convert": ["convert"],
    "convert-to-tf": ["convert-to-tf"],
    "plot": ["plot"],
    "plot-checkpoints": ["plot-checkpoints", "--model-dir", "/m"],
    "label": ["label", "--in-dir", "/x"],
    "export": ["export"],
    "serve": ["serve"],
    "doctor": ["doctor"],
    "bench": ["bench"],
}
# The port's new modules, which must import on a host without JAX,
# roomnet_tpu, TensorFlow or matplotlib (the card's).
OFFLINE_MODULES = ("roomnet_tpu_torch.params.convert_tf", "roomnet_tpu_torch.params.export_tf",
                   "roomnet_tpu_torch.params.export", "roomnet_tpu_torch.plotting.plotter",
                   "roomnet_tpu_torch.data.labeler", "roomnet_tpu_torch.utils.profiling",
                   "roomnet_tpu_torch.infer.server", "roomnet_tpu_torch.cli", "roomnet_tpu_torch.bench")


@pytest.fixture
def tiny_clis(monkeypatch, tmp_path):
    """Both CLIs pointed at the tiny geometry, and a tiny npz of
    init_variables(PRNGKey(3), TINY) with random BN statistics."""
    rng = np.random.RandomState(3)
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(3), TINY6))
    for k in flat:
        if "bn/" in k:
            n, field = flat[k].shape, k.rsplit("/", 1)[1]
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1,
                       "mean": rng.randn(*n) * 0.1, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    npz = str(tmp_path / "tiny.npz")
    np.savez(npz, **flat)

    def jax_load(params_path, model_dir=None):
        if model_dir:
            return jschema.unflatten_variables(jckpt.CheckpointStore(model_dir).load(cfg=TINY6)[0], TINY6)
        return jschema.unflatten_variables(dict(np.load(params_path)), TINY6)

    monkeypatch.setattr(jcli, "_model_cfg", lambda side, bf16: TINY6)
    monkeypatch.setattr(jcli, "_load_variables", jax_load)
    monkeypatch.setattr(tcli, "_model_cfg", lambda side, bf16: CFG6)
    return npz, flat


def run_jax(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)  # not jcli.main: its compile-cache setup changes the jax config


def write_images(d, n=7):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(5)
    for i in range(n):
        cv2.imwrite(os.path.join(d, f"photo {i}.png"), rng.randint(0, 256, (40 + 3 * i, 52, 3), np.uint8))
    with open(os.path.join(d, "corrupt.jpg"), "w") as f:
        f.write("not an image")
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["IMAGE_NAME", "PREDICTED_LABEL", "CONFIDENCE"]
    return {r[0]: (r[1], float(r[2])) for r in rows[1:]}


# -- the parser ----------------------------------------------------------------


def test_cli_parses_the_ported_subcommands_only():
    """Every subcommand of the JAX CLI, bench included, with the JAX CLI's
    flags (and --device where the command runs the model)."""
    p = tcli.build_parser()
    for argv in [*SUBCOMMANDS.values(),
                 ["infer", "--images-dir", "/x", "--no-overlay", "--exact", "--device", "cpu"],
                 ["serve", "--port", "0", "--drain", "10", "--auto-reload", "1", "--model-dir", "/m"],
                 ["serve", "--data-parallel", "--drain", "10"], ["serve", "--profile-port", "9999"],
                 ["eval-ckpts", "--model-dir", "/m", "--list-file", "/x", "--ckpt-backend", "npz"],
                 ["eval-ckpts", "--model-dir", "/m", "--list-file", "/x", "--ckpt-backend", "orbax", "--data-parallel"],
                 ["eval-ckpts", "--model-dir", "/m", "--list-file", "/x", "--plot", "/x.png"],
                 ["infer", "--images-dir", "/x", "--data-parallel"], ["validate", "--list-file", "/x", "--data-parallel"],
                 ["train", "--data-parallel"], ["train", "--ckpt-backend", "orbax"],
                 ["train", "--feed-mode", "sharded"], ["export", "--quantize", "dynamic"], ["export", "--format", "saved-model", "--out", "/tmp/sm"],
                 ["label", "--in-dir", "/x", "--no-resume"], ["bench", "--device", "cpu"]]:
        assert callable(p.parse_args(argv).fn)
    assert p.parse_args(["bench"]).fn is tcli.cmd_bench

    def flags(parser) -> dict:
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {o for a in sp._actions for o in a.option_strings} for name, sp in sub.choices.items()}

    port, ref = flags(p), flags(jcli.build_parser())
    assert set(port) == set(ref)
    for name in port:
        assert port[name] - ref[name] <= {"--device"}, name
        assert ref[name] - port[name] == set(), name


def test_defaults_are_the_jax_clis():
    """The reference's flags and defaults: serve --batch-size 32, the others
    64; every flag the port kept has the JAX CLI's default."""
    t, j = tcli.build_parser(), jcli.build_parser()
    for argv in SUBCOMMANDS.values():
        tv, jv = vars(t.parse_args(argv)), vars(j.parse_args(argv))
        for k in tv:
            if k not in ("fn", "device"):
                assert tv[k] == jv[k], (argv[0], k)
        assert tv.get("device", None) is None
    assert t.parse_args(["serve"]).batch_size == 32
    assert t.parse_args(SUBCOMMANDS["infer"]).batch_size == 64


def test_every_args_attribute_each_handler_reads_is_parsed():
    p = tcli.build_parser()
    checked = 0
    for name, argv in SUBCOMMANDS.items():
        ns = p.parse_args(argv)
        tree = ast.parse(inspect.getsource(ns.fn))
        reads = {node.attr for node in ast.walk(tree)
                 if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                 and node.value.id == "args"}
        missing = [a for a in reads if not hasattr(ns, a)]
        assert not missing, f"{name}: handler reads args.{missing} but the parser never defines them"
        checked += len(reads)
    assert checked > 25


def test_model_cfg_resolves_through_the_registry():
    assert tcli._model_cfg(224, bf16=False) is treg.get("roomnet-224")
    assert tcli._model_cfg(300, bf16=True) is treg.get("roomnet-300-bf16")
    with pytest.raises(ValueError):
        tcli._model_cfg(64, bf16=False)


# -- the subcommands against the JAX CLI ---------------------------------------


def test_infer_matches_the_jax_cli(tiny_clis, tmp_path, capsys):
    npz, _ = tiny_clis
    paths = write_images(str(tmp_path / "jax_imgs"))
    shutil.copytree(str(tmp_path / "jax_imgs"), str(tmp_path / "port_imgs"))
    run_jax(["infer", "--images-dir", str(tmp_path / "jax_imgs"), "--params", npz, "--exact",
             "--batch-size", "4", "--no-overlay"])
    tcli.main(["infer", "--images-dir", str(tmp_path / "port_imgs"), "--params", npz, "--exact",
               "--batch-size", "4", "--no-overlay", "--device", "cpu"])
    assert f"Results: {tmp_path / 'port_imgs'}_classified_results.xls" in capsys.readouterr().out
    want = read_csv(str(tmp_path / "jax_imgs") + "_classified_results.csv")
    got = read_csv(str(tmp_path / "port_imgs") + "_classified_results.csv")
    assert set(got) == set(want) == {os.path.basename(p) for p in paths} - {"corrupt.jpg"}
    for name, (label, conf) in want.items():
        assert got[name][0] == label
        assert abs(got[name][1] - conf) <= 1e-5
        assert os.path.exists(os.path.join(str(tmp_path / "port_imgs") + "_classified", label, name))


def test_validate_matches_the_jax_cli(tiny_clis, tmp_path, capsys):
    npz, flat = tiny_clis
    paths = write_images(str(tmp_path / "imgs"))
    clf = TC.RoomNetClassifier(tschema.variables_from_numpy(flat, CFG6, "cpu"), CFG6, batch_size=4,
                               device="cpu")
    ids, _, _ = clf.predict_paths(paths)
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{p} {int(i) if k % 3 else (int(i) + 1) % 6}\n"
                           for k, (p, i) in enumerate(zip(paths, ids))))
    capsys.readouterr()
    run_jax(["validate", "--list-file", str(lst), "--params", npz, "--exact", "--batch-size", "4"])
    want = json.loads(capsys.readouterr().out)
    tcli.main(["validate", "--list-file", str(lst), "--params", npz, "--exact", "--batch-size", "4",
               "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got == want and 0 < got["accuracy"] < 1


def test_eval_ckpts_matches_the_jax_cli(tiny_clis, tmp_path, capsys):
    npz, flat = tiny_clis
    paths = write_images(str(tmp_path / "imgs"))
    other = dict(flat)
    other["dense/2/kernel"] = np.roll(flat["dense/2/kernel"], 1, axis=1)
    store = jckpt.CheckpointStore(str(tmp_path / "ckpts"))
    store.save(jschema.unflatten_variables(other, TINY6), 10, suffix="0.3000")
    store.save(jschema.unflatten_variables(flat, TINY6), 20, suffix="interrupt")
    clf = TC.RoomNetClassifier(tschema.variables_from_numpy(flat, CFG6, "cpu"), CFG6, batch_size=4,
                               device="cpu")
    ids, _, _ = clf.predict_paths(paths)
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{p} {int(i)}\n" for p, i in zip(paths, ids)))
    common = ["eval-ckpts", "--model-dir", str(tmp_path / "ckpts"), "--list-file", str(lst),
              "--exact", "--batch-size", "4"]
    run_jax(common + ["--out", str(tmp_path / "jax.json")])
    capsys.readouterr()
    tcli.main(common + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    out = capsys.readouterr().out
    want, got = (json.load(open(str(tmp_path / f"{n}.json"))) for n in ("jax", "port"))
    assert got == want
    assert got["best"]["step"] == 20 and got["best"]["accuracy"] == 1.0
    assert "best: step 20  accuracy 1.0000  (roomnet--interrupt--20.npz)" in out


def test_serve_answers_as_the_jax_cli_serves(tiny_clis, monkeypatch, tmp_path, capsys):
    """cmd_serve of both CLIs on the same npz, each server started in place
    of its serve_forever: the same /classify answer for the same bytes, and
    --model-dir resume-latest with /reload."""
    npz, flat = tiny_clis
    started = []
    for cls in (JaxServer, ClassifierServer):
        monkeypatch.setattr(cls, "serve_forever", lambda self: started.append(self.start()))
    try:
        run_jax(["serve", "--params", npz, "--exact", "--port", "0", "--batch-size", "4", "--no-warmup"])
        mdir = str(tmp_path / "models")
        jckpt.CheckpointStore(mdir).save(jschema.unflatten_variables(flat, TINY6), 4)
        tcli.main(["serve", "--model-dir", mdir, "--exact", "--port", "0", "--batch-size", "4",
                   "--device", "cpu"])
        assert "loaded checkpoint at step 4" in capsys.readouterr().out
        jsrv, tsrv = started
        assert tsrv._bucket_sizes == [1, 2, 4] and tsrv.model_dir == mdir
        for seed in range(3):
            (js, jout), (ts, tout) = post(jsrv, "/classify", img_bytes(seed)), post(tsrv, "/classify", img_bytes(seed))
            assert js == ts == 200 and tout["label"] == jout["label"]
            np.testing.assert_allclose(tout["probs"], jout["probs"], rtol=0, atol=1e-5)
        assert post(tsrv, "/reload", b"") == (200, {"status": "reloaded", "step": 4})
    finally:
        for s in started:
            s.stop()


def test_commands_raise_without_a_gpu_unless_asked_for_the_cpu(tiny_clis, monkeypatch):
    """No silent fallback: with no CUDA device and no --device, each command
    raises before it loads anything; `python -m roomnet_tpu_torch serve`
    exits non-zero with the reason."""
    npz, _ = tiny_clis
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", "--params", npz], ["validate", "--list-file", "/x", "--params", npz],
                 ["infer", "--images-dir", "/x", "--params", npz],
                 ["eval-ckpts", "--model-dir", "/m", "--list-file", "/x"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
    proc = subprocess.run([sys.executable, "-m", "roomnet_tpu_torch", "serve", "--params", npz,
                           "--port", "0"], cwd=REPO, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))  # no GPU on any host
    assert proc.returncode != 0
    assert "none is available" in proc.stderr, proc.stderr[-500:]


def test_doctor_without_a_gpu_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["doctor", "--params", os.path.join(REPO, "artifacts", "roomnet_params.npz")])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] torch + CUDA device" in out
    assert "[PASS] converted reference params" in out and "178,062 params" in out
    assert "[PASS] golden parity fixtures" in out and "[PASS] cv2" in out
    assert "[PASS] tensorflow (offline convert/export only)" in out
    assert "[PASS] matplotlib (offline plots only)" in out
    # a missing params file is a WARN, never a crash
    with pytest.raises(SystemExit):
        tcli.main(["doctor", "--params", "/nonexistent/params.npz"])
    assert "[WARN] converted reference params" in capsys.readouterr().out


# -- profiling and logging -------------------------------------------------------


def test_spans_percentiles_ring_and_step_timer():
    reg = tprof._Registry()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprof, "SPANS", reg)
        with tprof.trace("unit_span"):
            pass
    s = reg.summary()
    assert s["unit_span"]["count"] == 1 and "p50_ms" in s["unit_span"] and "p99_ms" in s["unit_span"]
    reg.reset()
    for i in range(1, 101):
        reg.add("pct_span", i / 1000.0)
    p = reg.summary()["pct_span"]
    assert abs(p["p50_ms"] - 51) <= 2 and p["p99_ms"] >= 99
    for _ in range(2000):
        reg.add("ring_span", 0.001)
    assert len(reg._recent["ring_span"]) <= reg.RING
    reg.reset()
    reg.add("evict_span", 99.0)  # an outlier first sample leaves after exactly RING more
    for _ in range(reg.RING):
        reg.add("evict_span", 0.001)
    assert 99.0 not in reg._recent["evict_span"] and reg.summary()["evict_span"]["p99_ms"] < 10


def test_summary_raises_on_a_counter_and_a_span_sharing_a_name():
    """The reference's summary() silently lets a counter replace a span of
    the same name; the port's raises, and keeps the reference's keys."""
    reg = tprof._Registry()
    reg.add("serve/device_call", 0.002)
    reg.count("serve/device_call_bytes", 3072)
    assert reg.summary() == {
        "serve/device_call": {"total_s": 0.002, "count": 1, "mean_ms": 2.0, "p50_ms": 2.0, "p99_ms": 2.0},
        "serve/device_call_bytes": {"total": 3072, "count": 1}}
    ref = jprof._Registry()
    ref.add("serve/device_call", 0.002)
    ref.count("serve/device_call_bytes", 3072)
    assert ref.summary() == reg.summary()
    reg.count("serve/device_call", 1)
    with pytest.raises(ValueError, match="serve/device_call"):
        reg.summary()


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with tprof.trace_to(str(tmp_path / "trace")):
        with tprof.trace("traced_block"):
            torch.ones(16, 16).sum()
    data = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any(e.get("name") == "traced_block" for e in data["traceEvents"])


def test_event_log_and_logger(tmp_path):
    log = tlogging.EventLog(str(tmp_path / "events.jsonl"))
    log.emit("step", loss=1.5, step=3)
    log.emit("val", accuracy=0.9)
    lines = [json.loads(l) for l in open(tmp_path / "events.jsonl")]
    assert lines[0]["kind"] == "step" and lines[0]["loss"] == 1.5 and lines[1]["accuracy"] == 0.9
    tlogging.EventLog(None).emit("noop")
    assert tlogging.get_logger("server").name == "roomnet_tpu_torch.server"


def test_predict_stream_records_the_jax_pipelines_spans(tmp_path):
    """predict_paths over 10 files at batch 4 through both packages: the port
    records e2e/decode, e2e/wait_decode and e2e/dispatch once per batch and
    e2e/fetch once per call, as the JAX pipeline does; on the CPU there is
    no copy to the device, so no e2e/device_put or e2e/wait_put. The port's
    own stage/wait_fill and stage/fill_bytes stay out of e2e/*, which
    `bench.py` reads whole."""
    paths = write_images(str(tmp_path / "imgs"), n=10)[:-1]  # the corrupt file aside: 9 images
    paths.append(paths[0])
    flat = jschema.flatten_variables(jax_init(jax.random.PRNGKey(0), TINY))
    tclf = TC.RoomNetClassifier(tschema.variables_from_numpy(flat, tiny_config(), "cpu"), tiny_config(),
                                batch_size=4, class_labels=LABELS4, device="cpu")
    jclf = JC.RoomNetClassifier(jschema.unflatten_variables(flat, TINY), TINY, batch_size=4,
                                class_labels=LABELS4)
    tprof.SPANS.reset()
    jprof.SPANS.reset()
    tclf.predict_paths(paths)
    jclf.predict_paths(paths)
    got, want = tprof.SPANS.summary(), jprof.SPANS.summary()
    for name in ("e2e/decode", "e2e/wait_decode", "e2e/dispatch", "e2e/fetch"):
        assert got[name]["count"] == want[name]["count"], name
    assert got["e2e/decode"]["count"] == 3 and got["e2e/fetch"]["count"] == 1
    assert "e2e/device_put" not in got and "e2e/wait_put" not in got
    assert want["e2e/device_put"]["count"] == 3
    assert {k for k in got if k.startswith("e2e/")} == {"e2e/decode", "e2e/wait_decode", "e2e/dispatch",
                                                        "e2e/fetch"}
    assert got["stage/wait_fill"]["count"] == 3 and got["stage/fill_bytes"]["count"] == 3


# -- this slice's subcommands and flags -------------------------------------------


def test_eval_ckpts_plot_writes_the_png(tiny_clis, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    npz, flat = tiny_clis
    paths = write_images(str(tmp_path / "imgs"), n=3)[:-1]
    store = jckpt.CheckpointStore(str(tmp_path / "ckpts"))
    store.save(jschema.unflatten_variables(flat, TINY6), 10, suffix="0.5000")
    store.save(jschema.unflatten_variables(flat, TINY6), 20, suffix="interrupt")
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{p} 0\n" for p in paths))
    png = str(tmp_path / "sweep.png")
    tcli.main(["eval-ckpts", "--model-dir", str(tmp_path / "ckpts"), "--list-file", str(lst), "--exact",
               "--batch-size", "4", "--device", "cpu", "--plot", png])
    assert f"plot: {png}" in capsys.readouterr().out
    assert cv2.imread(png) is not None and os.path.getsize(png) > 1000


def test_plot_and_label_subcommands(tmp_path, capsys, monkeypatch):
    pytest.importorskip("matplotlib")
    stats = [{"step": s, "accuracy": 0.5 + s / 100, "precisions": [0.5] * 6, "recalls": [0.4] * 6,
              "f-scores": [0.3] * 6} for s in (20, 10)]
    (tmp_path / "stats.json").write_text(json.dumps(stats))
    tcli.main(["plot", "--stats", str(tmp_path / "stats.json"), "--out-dir", str(tmp_path / "plots")])
    assert sorted(os.listdir(tmp_path / "plots")) == ["accuracy_plot.png", "fscore_plot.png", "precision_plot.png",
                                                      "recall_plot.png"]
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "roomnet--0.5--10.npz").write_bytes(b"x")
    tcli.main(["plot-checkpoints", "--model-dir", str(tmp_path / "models")])
    assert os.path.exists(str(tmp_path / "models") + "_accuracy_plot.png")
    write_images(str(tmp_path / "unlabeled"), n=2)
    keys = iter(["a", "b", "q"])
    monkeypatch.setattr("builtins.input", lambda *_: next(keys))
    monkeypatch.delenv("DISPLAY", raising=False)
    tcli.main(["label", "--in-dir", str(tmp_path / "unlabeled")])
    assert "Aborted by user" in capsys.readouterr().out
    assert (tmp_path / "unlabeled-labelled" / "labels.csv").read_text().splitlines() == ["corrupt.jpg,97",
                                                                                         "photo 0.png,98"]


def test_export_subcommand_writes_a_tflite_on_the_cpu(tiny_clis, tmp_path, capsys, monkeypatch):
    """export loads the weights on the CPU (no GPU needed) in the f32 config,
    as the JAX CLI does; --quantize is refused for a SavedModel."""
    tf = pytest.importorskip("tensorflow")
    npz, _ = tiny_clis
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "tiny.tflite")
    tcli.main(["export", "--params", npz, "--out", out])
    assert f"exported: {out}" in capsys.readouterr().out
    interp = tf.lite.Interpreter(model_path=out)
    assert list(interp.get_input_details()[0]["shape"]) == [1, 32, 32, 3]
    with pytest.raises(SystemExit, match="TFLite only"):
        tcli.main(["export", "--format", "saved-model", "--quantize", "dynamic"])


def test_serve_data_parallel_and_profile_port_are_served(tiny_clis, monkeypatch, capsys):
    """serve --data-parallel on one process: a world of one, buckets from
    the data axis (1), answers as without the mesh; --profile-port starts
    the capture server; main ends the process group after the server."""
    import torch.distributed as dist

    from chip_smoke import free_port

    npz, flat = tiny_clis
    port, seen = free_port(), {}

    def serve(self):  # the server's life, with requests in place of a signal
        self.start()
        try:
            seen["buckets"], seen["mesh"] = self._bucket_sizes, self.classifier.mesh
            seen["answer"] = post(self, "/classify", img_bytes(0))
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?seconds=0.2", timeout=60) as r:
                seen["trace"] = json.loads(r.read())["trace"]
        finally:
            self.stop()
        return 0

    monkeypatch.setattr(ClassifierServer, "serve_forever", serve)
    assert tcli.main(["serve", "--params", npz, "--exact", "--port", "0", "--batch-size", "4", "--device", "cpu",
                      "--data-parallel", "--profile-port", str(port)]) == 0
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert f"capture server on :{port}" in out and "serving on" in out
    assert seen["mesh"] is not None and seen["mesh"].shape == {"data": 1, "model": 1}
    assert seen["buckets"] == [1, 2, 4] and os.path.getsize(seen["trace"]) > 0
    clf = TC.RoomNetClassifier(tschema.variables_from_numpy(flat, CFG6, "cpu"), CFG6, batch_size=4, device="cpu")
    im = clf.prep_decoded(cv2.imdecode(np.frombuffer(img_bytes(0), np.uint8), cv2.IMREAD_COLOR))
    _, probs = clf._predict(clf.variables, torch.from_numpy(im[None]))
    status, answer = seen["answer"]
    assert status == 200
    np.testing.assert_array_equal(np.asarray(answer["probs"], np.float32), probs[0].numpy())


def test_profiling_start_server_captures_every_thread(tmp_path):
    """GET /capture?seconds=S records the spans of another thread into a
    chrome trace under the server's directory; bad requests are refused."""
    import threading
    import urllib.error

    stop = threading.Event()

    def work():
        while not stop.is_set():
            with tprof.trace("worker_thread_span"):
                torch.ones(16, 16).matmul(torch.ones(16, 16))
            stop.wait(0.005)

    t = threading.Thread(target=work)
    t.start()
    srv = tprof.start_server(0, str(tmp_path / "prof"))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/capture?seconds=0.3", timeout=60) as r:
            got = json.loads(r.read())
        assert got["trace"] == str(tmp_path / "prof" / "capture_0001" / "trace.json")
        events = json.load(open(got["trace"]))["traceEvents"]
        assert any(e.get("name") == "worker_thread_span" for e in events)
        for q in ("seconds=0", "seconds=x", "seconds=1000"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/capture?{q}", timeout=10)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/other", timeout=10)
        assert e.value.code == 404
    finally:
        stop.set()
        t.join(10)
        srv.shutdown()
    assert not t.is_alive()


def test_new_modules_import_without_jax_tensorflow_or_matplotlib():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'roomnet_tpu', 'tensorflow', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in OFFLINE_MODULES)
            + "import roomnet_tpu_torch.cli as c\n"
            "c.build_parser().parse_args(['export'])\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
