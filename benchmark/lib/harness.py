"""One run of one cell: find its files by name, run its driver, print the
result line.

A cell's pieces are found by the names in BENCHMARK.json, so a cell, a
configuration or a per-layer metric is added with files and entries alone:

  * the configuration: the `file` of its `configs` entry, whose "arch"
    names benchmark/arch/<arch>/, the folder of everything that knows the
    model's equations: `reference.py` (the plain float32 forward, its
    lower precisions, `param_paths`, the CPU tests' `TINY`), `weights.py`
    (seeded weights, `nest` into the program's tree), `work.py` (the work
    counts of the roofline and MFU readers) and `program.py` (the
    architecture's only import of the program: its configuration and
    classifier), handed to drivers and readers as `cell.arch`;
  * the traffic: benchmark/workloads/<cell>.json, whose "driver" names
    benchmark/drivers/<driver>.py and whose "traffic" holds its parameters
    ("name" as BENCHMARK.json's `traffic`) and "limits" the numbers that
    decide `correct`;
  * each per-layer metric: benchmark/metrics/<metric>.py, a reader
    `read(readings) -> float | None` (None: nothing to read, left out).

A metric split by cells, `<base>.<part>` (one name for each set of cells
whose spread a bound has to fit, or whose cells report different
end-to-end metrics), is the quantity `<base>`: an end-to-end one takes
the driver's value of `<base>`, a per-layer one the reader
metrics/<base>.py where there is no metrics/<base>.<part>.py. A split
is made with entries alone.

A driver's `run(ctx)` builds the cell's traffic, weights and program,
warms up, runs its measured loop from `ctx.window()` on (a closed loop of
one caller: `window.closed_loop`), checks what the timed path produced,
and returns an `Outcome`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.machinery
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "roomnet_tpu")


def process_start_monotonic() -> float:
    """time.monotonic() at this process's start (Linux: /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among `names` (default: sys.modules) that a run may
    not load, compared whole: `roomnet_tpu_torch` is not `roomnet_tpu`."""
    return sorted({m.split(".")[0] for m in list(sys.modules if names is None else names)} & set(FORBIDDEN))


def load_module(path: pathlib.Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARCH_MODULES = ("reference", "weights", "work", "program")


def load_arch(arch: str, root: pathlib.Path = ROOT) -> types.SimpleNamespace:
    """The modules of benchmark/arch/<arch>/ (ARCH_MODULES), as attributes
    of one namespace. They are imported as one package, once per folder
    and process, so that they import one another relatively and every
    caller shares them (faults.py patches `program` there)."""
    folder = root / "benchmark" / "arch" / arch
    if not (folder / "reference.py").is_file():
        raise FileNotFoundError(f"no architecture {arch!r}: {folder} holds no reference.py")
    package = "bench_arch_" + hashlib.sha256(str(folder.resolve()).encode()).hexdigest()[:16]
    if package not in sys.modules:
        spec = importlib.machinery.ModuleSpec(package, None, is_package=True)
        spec.submodule_search_locations = [str(folder)]
        sys.modules[package] = importlib.util.module_from_spec(spec)
    return types.SimpleNamespace(name=arch, **{m: importlib.import_module(f"{package}.{m}") for m in ARCH_MODULES})


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # BENCHMARK.json's workloads entry
    config: dict  # the configuration file
    workload: dict  # benchmark/workloads/<name>.json
    end_to_end: list  # the metrics entries this cell reports
    per_layer: list
    arch: types.SimpleNamespace  # load_arch(config["arch"])
    root: pathlib.Path = ROOT  # the checkout whose files it was found in


def base_name(name: str) -> str:
    """`<base>` of a split metric's name `<base>.<part>`; else the name."""
    return name.rsplit(".", 1)[0]


def reader_path(root: pathlib.Path, name: str) -> pathlib.Path:
    """The reader of the per-layer metric `name`: metrics/<name>.py, else
    that of the quantity it splits."""
    own = root / "benchmark" / "metrics" / f"{name}.py"
    return own if own.is_file() else root / "benchmark" / "metrics" / f"{base_name(name)}.py"


def metric_applies(metric: dict, cell: str, reported_e2e: set) -> bool:
    """A per-layer metric is read in the cells it lists, else in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported_e2e


def resolve(name: str, root: pathlib.Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    workload = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    configs = {c["name"]: c for c in manifest["configs"]}
    config_file = configs[entry["config"]]["file"]
    config = json.loads((root / config_file).read_text())
    if "arch" not in config:
        raise KeyError(f"{config_file} names no \"arch\": the folder benchmark/arch/<arch>/ of its model")
    if not (root / "benchmark" / "drivers" / f"{workload['driver']}.py").is_file():
        raise FileNotFoundError(f"{name}: no driver {workload['driver']!r} under benchmark/drivers")
    if workload["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"{name}: the workload file's traffic {workload['traffic']['name']!r} is not "
                         f"BENCHMARK.json's {entry['traffic']!r}")
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if metric_applies(m, name, names)]
    return Cell(name, entry, config, workload, e2e, per_layer, load_arch(config["arch"], root), root)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end values by metric name, the
    readings the per-layer readers take, the counts, the numbers that
    decide `correct` as (name, value, limit), and the device's peak."""

    e2e: dict
    readings: types.SimpleNamespace
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)


class Context:
    """What a driver gets: the cell, its architecture's modules, its seed,
    window length and trace flag, the device, and the set-up clock (`part`,
    `window`)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, log=None):
        self.cell, self.arch, self.seed, self.seconds, self.trace = cell, cell.arch, seed, seconds, trace
        self.cfg, self.traffic, self.limits = cell.config, cell.workload["traffic"], cell.workload["limits"]
        self.device = device
        self.t_start = t_start
        self.parts: dict[str, float] = {}
        self.window_start: float | None = None
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.monotonic() - t0
            self.log(f"setup {name}: {self.parts[name]:.3f} s")

    def window(self, at: float | None = None) -> float:
        """Mark the end of set-up: now (call just before the measured loop),
        or at the time.monotonic() value `at`."""
        self.window_start = time.monotonic() if at is None else at
        self.log(f"setup_s {self.window_start - self.t_start:.3f} (parts: "
                 + ", ".join(f"{k} {v:.3f}" for k, v in self.parts.items()) + ")")
        return self.window_start


def device_info(device, memory_peak_bytes: int, trace=None) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info


def load_driver(cell: Cell) -> types.ModuleType:
    name = cell.workload["driver"]
    return load_module(cell.root / "benchmark" / "drivers" / f"{name}.py", f"bench_driver_{name}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run the cell once and return the result line's object (the keys
    `correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
    `breakdown`, and `checks` last)."""
    driver = load_driver(cell)
    ctx = Context(cell, seed, seconds, trace, device, t_start)
    ctx.parts["start"] = time.monotonic() - t_start  # the interpreter, imports
    ctx.log(f"setup start: {ctx.parts['start']:.3f} s")
    out: Outcome = driver.run(ctx)
    if ctx.window_start is None:
        raise RuntimeError(f"driver {cell.workload['driver']} never opened its window")
    metrics = {}
    if not trace:
        values = {**out.e2e, "setup_s": ctx.window_start - t_start}
        for m in cell.end_to_end:
            key = m["name"] if m["name"] in values else base_name(m["name"])
            if key not in values:
                raise KeyError(f"{cell.name}: the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(values[key]), "unit": m["unit"]}
    else:
        r = out.readings
        for m in cell.per_layer:
            reader = load_module(reader_path(cell.root, m["name"]),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    tr = getattr(out.readings, "trace", None)
    result = {"correct": bool(out.correct), "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device_info(device, out.memory_peak_bytes, tr if trace else None)}
    if trace and tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in out.checks}
    return result


def main(argv=None) -> int:
    import argparse

    t_start = process_start_monotonic()
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The result line, last on standard output; then each number compared
    beside its limit, last on standard error."""
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr, flush=True)
