"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of every piece by name."""

from __future__ import annotations

import ast
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import harness

from .conftest import CELLS, cells, manifest, run_tiny, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def one_line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(one_line(w) for w in m["command"])
    for word in m["command"]:
        assert not word.startswith("/") and ".." not in word
        if (harness.ROOT / word).exists():
            assert any(word == p or word.startswith(p + "/") for p in m["paths"]), word
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # A full check of 24 cells fits the check's time.
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    m = manifest()
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
    four = 0
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        four += w["chips"] == 4
    assert four <= max(1, len(m["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    cells = {w["name"] for w in m["workloads"]}
    for metric in m["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    setup = [e for e in m["end_to_end"] if e["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] == 0.25
    e2e = {e["name"]: e for e in m["end_to_end"]}
    layers = {}
    for metric in m["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in SOURCES and one_line(metric["layer"]) and metric["moves"] in e2e
        layers.setdefault(metric["layer"].lower(), set()).add(metric["layer"])
        for cell in metric.get("workloads", cells):
            moved = e2e[metric["moves"]]
            assert cell in cells and cell in moved.get("workloads", cells), (metric["name"], cell)
        if metric["name"].endswith("_roofline") or "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), "one layer, one spelling"
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in m["end_to_end"] + m["per_layer"])) == len(m["end_to_end"]) + len(m["per_layer"])
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        reported = {e["name"] for e in m["end_to_end"] if cell in e.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in p.get("workloads", cells) for p in m["per_layer"])
    for c in m["configs"]:
        assert any(w["config"] == c["name"] for w in m["workloads"])


def test_every_workload_file_is_a_listed_cell():
    files = {p.stem for p in (harness.ROOT / "benchmark" / "workloads").glob("*.json")}
    assert files == set(CELLS)
    with pytest.raises(KeyError):
        harness.resolve("no-such-cell")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_its_files_by_name(name):
    cell = harness.resolve(name)
    bench = harness.ROOT / "benchmark"
    assert (bench / "drivers" / f"{cell.workload['driver']}.py").is_file()
    assert (bench / "workloads" / f"{name}.json").is_file()
    assert cell.per_layer and all(harness.reader_path(harness.ROOT, m["name"]).is_file() for m in cell.per_layer)
    assert set(cell.workload) >= {"driver", "traffic", "limits"} and cell.workload["limits"]


@pytest.mark.parametrize("name", [c["name"] for c in manifest()["configs"]])
def test_configuration_files_hold_what_their_entries_say(name):
    entry = next(c for c in manifest()["configs"] if c["name"] == name)
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert NAME.match(cfg["arch"])
    ref = harness.load_arch(cfg["arch"]).reference
    assert sum(math.prod(s) for s in ref.param_paths(cfg).values()) == cfg["params"]
    assert cfg["precision"] in ("bf16", "f32")


def test_a_configuration_without_an_arch_is_refused(tmp_path):
    root = copy_benchmark(tmp_path)
    cfg_file = root / manifest(root)["configs"][0]["file"]
    cfg = json.loads(cfg_file.read_text())
    del cfg["arch"]
    cfg_file.write_text(json.dumps(cfg))
    name = next(w["name"] for w in manifest(root)["workloads"] if w["config"] == cfg["name"])
    with pytest.raises(KeyError, match="arch"):
        harness.resolve(name, root)


def copy_benchmark(dst: pathlib.Path) -> pathlib.Path:
    shutil.copy(harness.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(harness.ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "bench_out"))
    return dst


def test_a_cell_config_and_metric_are_added_with_files_and_entries_alone(tmp_path):
    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    template = tiny_cell(CELLS[0])
    (root / "benchmark" / "configs" / "roomnet-tiny-bf16.json").write_text(
        json.dumps({**template.arch.reference.TINY, "name": "roomnet-tiny-bf16", "precision": "bf16",
                    "reduced": []}))
    wl = json.loads((root / "benchmark" / "workloads" / f"{CELLS[0]}.json").read_text())
    wl["traffic"].update(template.workload["traffic"], name="tiny-traffic")
    (root / "benchmark" / "workloads" / "tiny-cell.json").write_text(json.dumps(wl))
    (root / "benchmark" / "metrics" / "window_s.tiny.py").write_text("def read(r):\n    return r.window_s\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "roomnet-tiny-bf16", "source": "https://example.org/roomnet-tiny",
                         "file": "benchmark/configs/roomnet-tiny-bf16.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "tiny-cell", "config": "roomnet-tiny-bf16",
                           "traffic": "tiny-traffic", "chips": 1, "why": "a test"})
    moved = next(e for e in template.end_to_end if e["name"] != "setup_s")
    next(e for e in m["end_to_end"] if e["name"] == moved["name"]).setdefault("workloads", []).append("tiny-cell")
    m["per_layer"].append({"name": "window_s.tiny", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "a test", "moves": moved["name"],
                           "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert cells(root)[-1] == "tiny-cell"  # the tests' cells, from the manifest
    cell = harness.resolve("tiny-cell", root)
    assert cell.root == root and cell.config["im_side"] == 32
    plain = run_tiny(cell)
    traced = run_tiny(cell, trace=True)
    assert plain["correct"] and set(plain["metrics"]) == {moved["name"], "setup_s"}
    assert traced["metrics"]["window_s.tiny"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before, "no file of the benchmark was edited"


# A second architecture as a later change would add it: a small plain-torch
# convnet (conv3x3 with zero padding, ReLU, global mean, dense, softmax)
# with its reference, weights, work counts, TINY and a program of its own.
STANDIN = {
    "reference.py": """
import numpy as np
import torch
import torch.nn.functional as F

TINY = {"name": "standin-tiny", "arch": "standin", "num_classes": 4, "im_side": 16, "width": 8}


def param_paths(cfg):
    return {"conv": (3, 3, 3, cfg["width"]), "dense/kernel": (cfg["width"], cfg["num_classes"]),
            "dense/bias": (cfg["num_classes"],)}


def rounder(prec):
    return (lambda x: x.to(torch.bfloat16).float()) if prec in ("bf16", "fp8") else (lambda x: x)


@torch.no_grad()
def probs(v, x, cfg, prec="f32", rows=256):
    q, out = rounder(prec), []
    for at in range(0, len(x), rows):
        xb = torch.as_tensor(x[at: at + rows]).to(v["conv"].device).float().permute(0, 3, 1, 2) / 127.5 - 1
        h = F.relu(q(F.conv2d(xb, q(v["conv"]).permute(3, 2, 0, 1), padding=1))).mean((2, 3))
        out.append(torch.softmax(h @ v["dense/kernel"] + v["dense/bias"], -1).double().cpu().numpy())
    return np.concatenate(out)
""",
    "weights.py": """
import torch

from benchmark.lib import images

from . import reference


def make(cfg, seed, calib_x, device):
    g = images.torch_generator(seed, 3, device)
    return {p: torch.randn(s, generator=g, device=device) for p, s in reference.param_paths(cfg).items()}


def nest(flat, cfg):
    return flat
""",
    "work.py": """
from benchmark.lib.peaks import HBM_BYTES_PER_S, PEAK_F32


def launches(cfg, batch):
    s, c = cfg["im_side"], cfg["width"]
    macs = batch * s * s * 27 * c
    return [{"kernel": "conv", "bytes": 4 * batch * s * s * (3 + c), "ops": 2 * macs, "flops": 2 * macs}]


def bound_s(cfg, batch, kernel):
    return sum(max(x["bytes"] / HBM_BYTES_PER_S, x["ops"] / PEAK_F32)
               for x in launches(cfg, batch) if x["kernel"] == kernel)


def forward_flops(cfg, batch):
    return float(sum(x["flops"] for x in launches(cfg, batch)))


def forward_ideal_s(cfg, batch):
    return forward_flops(cfg, batch) / PEAK_F32
""",
    "program.py": """
import numpy as np
import torch
import torch.nn.functional as F


class Classifier:
    def __init__(self, variables, cfg, batch_size, device):
        self.variables, self.batch_size, self.device = variables, batch_size, device

    def _predict(self, variables, x):
        x = x.float().permute(0, 3, 1, 2) / 127.5 - 1
        h = F.relu(F.conv2d(x, variables["conv"].permute(3, 2, 0, 1), padding=1)).mean((2, 3))
        probs = torch.softmax(h @ variables["dense/kernel"] + variables["dense/bias"], -1)
        return probs.argmax(-1), probs

    def predict(self, x):
        out = [self._predict(self.variables, torch.as_tensor(x[at: at + self.batch_size]).to(self.device))
               for at in range(0, len(x), self.batch_size)]
        return (np.concatenate([i.cpu().numpy() for i, _ in out]),
                np.concatenate([p.cpu().numpy() for _, p in out]))

    def close(self):
        pass


def classifier(variables, cfg, batch_size, device):
    return Classifier(variables, cfg, batch_size, device)
""",
}


def test_a_second_architecture_is_added_with_files_and_entries_alone(tmp_path):
    """In a copy: a stand-in architecture's folder, a configuration, a cell
    and a per-layer metric split of an existing reader; it resolves, runs
    end to end on the CPU with and without the trace, and the copy passes
    the manifest tests and the driver tests of its cell, with no file of
    the benchmark edited."""
    root = copy_benchmark(tmp_path)
    (root / "roomnet_tpu_torch").symlink_to(harness.ROOT / "roomnet_tpu_torch")
    shutil.copy(harness.ROOT / "pyproject.toml", root / "pyproject.toml")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    folder = root / "benchmark" / "arch" / "standin"
    folder.mkdir()
    for name, source in STANDIN.items():
        (folder / name).write_text(source.lstrip())
    (root / "benchmark" / "configs" / "standin-16.json").write_text(json.dumps(
        {"name": "standin-16", "arch": "standin", "source": "https://example.org/standin", "num_classes": 4,
         "im_side": 16, "width": 8, "precision": "f32", "params": 27 * 8 + 8 * 4 + 4, "reduced": []}))
    (root / "benchmark" / "workloads" / "standin-cell.json").write_text(json.dumps(
        {"driver": "infer_closed", "limits": {"max_prob_gap": 1e-4},
         "traffic": {"name": "standin-traffic", "batch_size": 8, "images_per_call": 32, "bases": 4, "noise": 16,
                     "calib_images": 8}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "standin-16", "source": "https://example.org/standin",
                         "file": "benchmark/configs/standin-16.json", "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "standin-cell", "config": "standin-16", "traffic": "standin-traffic",
                           "chips": 1, "why": "a test"})
    m["end_to_end"].insert(0, {"name": "infer_img_per_s.standin", "unit": "img/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock", "workloads": ["standin-cell"]})
    m["per_layer"].append({"name": "device_idle_pct.standin", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "infer_img_per_s.standin",
                           "workloads": ["standin-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.resolve("standin-cell", root)
    assert cell.arch.name == "standin" and cell.config["width"] == 8
    small = tiny_cell("standin-cell", root)
    assert small.config["name"] == "standin-tiny"
    plain, traced = run_tiny(small), run_tiny(small, trace=True)
    assert plain["correct"] and set(plain["metrics"]) == {"infer_img_per_s.standin", "setup_s"}
    assert traced["correct"] and set(traced["metrics"]) == set()  # its one reader needs the card's trace
    env = {**clean_env(), "PYTHONDONTWRITEBYTECODE": "1"}
    for args in (["benchmark/tests/test_benchmark_manifest.py", "-k", "not second_architecture"],
                 ["benchmark/tests/test_benchmark_drivers.py", "-k", "standin"]):
        proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *args], cwd=root,
                              env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0 and " passed" in proc.stdout, proc.stdout[-3000:] + proc.stderr[-2000:]
    after = {p: p.read_bytes() for p in before}
    assert after == before, "no file of the benchmark was edited"


def clean_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_the_command_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, env=clean_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails_without_the_program(tmp_path):
    """Only BENCHMARK.json and benchmark/: the program is missing, the run
    ends with an error and prints no result (on the CPU, past the card's
    check)."""
    root = copy_benchmark(tmp_path)
    code = ("import sys, time, pathlib, torch; sys.path[0] = '.';"
            "from benchmark.lib import harness;"
            "c = harness.resolve(%r, pathlib.Path('.'));"
            "print(harness.run_cell(c, 1, 0.1, False, torch.device('cpu'), time.monotonic()))"
            % CELLS[0])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "roomnet_tpu_torch" in proc.stderr


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["roomnet_tpu_torch", "roomnet_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["roomnet_tpu.models.roomnet", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "roomnet_tpu"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = set()
    for path in (harness.ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                seen.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                seen.add(node.module)
    assert "roomnet_tpu_torch.infer.classify" in seen
    assert harness.forbidden_modules(seen) == []


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import sys, time, pathlib, json, torch; sys.path[0] = %r;"
            "from benchmark.tests.conftest import tiny_cell, run_tiny;"
            "from benchmark.lib import harness;"
            "r = run_tiny(tiny_cell(%r), trace=True);"
            "print(json.dumps({'bad': harness.forbidden_modules(), 'correct': r['correct']}))"
            % (str(harness.ROOT), CELLS[0]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=clean_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"bad": [], "correct": True}
