"""Ranks of the port's data-parallel tests: processes that import the port
and never JAX, joined over gloo on the CPU through a FileStore.

`spawn(job, world, workdir, **kwargs)` starts `world` processes of this
module, each running `job(rank, world, workdir, **kwargs)` (a function
below) in its process group, and returns each rank's result (a pickled
value written to workdir). A job's `device` keyword is each rank's device
(default the CPU): "cuda" puts every rank on the one card, still over gloo,
since NCCL refuses two ranks on one device. The group's collectives time out after 60 s and
each spawn has its own join limit, so a collective that never completes
fails its test instead of hanging the suite.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60.0


def spawn(job: str, world: int, workdir, timeout_s: float = 240.0, **kwargs) -> list:
    """Run `job` on `world` ranks; each rank's return value, by rank.
    Raises with the ranks' output when one fails or the join times out."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.pkl"), "wb") as f:
        pickle.dump((job, kwargs), f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        env.pop(k, None)
    # Run by path: a machine may have another package named `tests` installed.
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), workdir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {job} exited {p.returncode}:\n{out[-4000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def main():
    rank, world, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from roomnet_tpu_torch.parallel import distributed

    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        job, kwargs = pickle.load(f)
    assert distributed.initialize(f"file://{os.path.join(workdir, 'pg_store')}", world, rank, backend="gloo",
                                  device=kwargs.get("device", "cpu"), timeout_s=PG_TIMEOUT_S)
    try:
        result = globals()[job](rank, world, workdir, **kwargs)
    finally:
        distributed.shutdown()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# -- helpers -----------------------------------------------------------------


def tiny(num_classes: int = 4):
    from chip_smoke import tiny_config

    return dataclasses.replace(tiny_config(), num_classes=num_classes)


def numpy_state(state) -> dict:
    from chip_smoke import state_tensors

    return {k: v.detach().cpu().numpy().copy() for k, v in state_tensors(state).items()}


@contextlib.contextmanager
def mutated(module, old: str, new: str):
    """`module` with `old` in its source replaced by `new` (exactly one
    occurrence) for the block: a planted fault, in this process alone."""
    src = inspect.getsource(module)
    if src.count(old) != 1:
        raise AssertionError(f"{module.__name__}: the fault's anchor occurs {src.count(old)} times: {old!r}")
    exec(compile(src.replace(old, new), module.__file__, "exec"), module.__dict__)
    try:
        yield
    finally:
        exec(compile(src, module.__file__, "exec"), module.__dict__)


# Planted faults of the data-parallel step: (module, anchor, replacement).
FAULTS = {
    # BN moments of this rank's rows alone.
    "per_rank_bn": ("roomnet_tpu_torch.ops.blocks", "    axes = tuple(range(x.ndim - 1))\n    x32 = x.float()\n",
                    "    group = None\n    axes = tuple(range(x.ndim - 1))\n    x32 = x.float()\n"),
    # DDP's mean of per-rank means in place of the global-count division.
    "mean_over_ranks": ("roomnet_tpu_torch.train.step", "count = C.all_reduce_sum(local, group)",
                        "count = local * world"),
    # The L2 term counted once per rank.
    "l2_on_every_rank": ("roomnet_tpu_torch.train.step", "+ l2 / world, (logits", "+ l2, (logits"),
    # Tensor parallelism: the gather's backward sums over 'model' (the world
    # is the row of a (1, 2) mesh) instead of taking this rank's slice.
    "gather_backward_sums": ("roomnet_tpu_torch.parallel.tensor",
                             "return grad.narrow(ctx.axis, ctx.index * ctx.width, ctx.width).contiguous(), None, None",
                             "return (C.all_reduce_sum(grad.narrow(ctx.axis, ctx.index * ctx.width, ctx.width)"
                             ".contiguous(), dist.group.WORLD), None, None)"),
    # No dgrad all-reduce: copy_to_model's backward left out.
    "no_copy_to_model": ("roomnet_tpu_torch.parallel.tensor",
                         "        g = grad.contiguous().clone()\n        dist.all_reduce(g, group=ctx.group)\n"
                         "        return g, None\n", "        return grad, None\n"),
    # The gradient all-reduce over the world instead of the data group.
    "grads_over_world": ("roomnet_tpu_torch.train.step", "+ [loss.reshape(1), hit_sum.reshape(1)]), group)",
                         "+ [loss.reshape(1), hit_sum.reshape(1)]), torch.distributed.group.WORLD)"),
    # The loss metric with the L2 of this rank's slices alone.
    "l2_metric_local_slices": ("roomnet_tpu_torch.train.step",
                               "        l2 = l2 + hp.l2_coeff * 0.5 * (C.all_reduce_sum(mine, tp.group) - mine)",
                               "        l2 = l2"),
    # The mesh server's buckets from 1, not from the data axis.
    "bucket_base_1": ("roomnet_tpu_torch.infer.server", 'base = int(mesh.shape["data"])', "base = 1"),
    # A mesh reload that swaps rank 0 alone.
    "reload_rank0_only": ("roomnet_tpu_torch.infer.server",
                          "except ValueError as exc:\n            return 409, {\"error\": f\"checkpoint rejected: "
                          "{type(exc).__name__}: {exc}\"}\n        return self._swap(variables, step)\n",
                          "except ValueError as exc:\n            return 409, {\"error\": f\"checkpoint rejected: "
                          "{type(exc).__name__}: {exc}\"}\n        return self._swap(variables, step) "
                          "if self.rank == 0 else (200, {})\n"),
}


# -- jobs --------------------------------------------------------------------


def mesh_layout(rank, world, workdir):
    """make_mesh's shapes, coordinates and groups on this rank."""
    import torch
    import torch.distributed as dist

    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh

    out = {"count": distributed.process_count(), "index": distributed.process_index()}
    for shape in ((world, 1), (1, world), (None, 1)):
        mesh = make_mesh(*shape, devices="cpu")
        g = mesh.group("data")
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t, group=g)
        out[shape] = {"devices": mesh.devices.tolist(), "axis_names": mesh.axis_names, "shape": dict(mesh.shape),
                      "coords": mesh.coords, "device": str(mesh.device), "group_size": dist.get_world_size(g),
                      "group_sum": float(t)}
    global_mesh = distributed.global_mesh()
    out["global"] = dict(global_mesh.shape)
    return out


def bn_moments(rank, world, workdir, x, bn, weights, grad_out):
    """batch_norm_train on this rank's rows with the data group: y, the
    stats and the gradients of sum(y * grad_out) for x, scale and bias."""
    import torch
    import torch.distributed as dist

    from roomnet_tpu_torch.ops.blocks import batch_norm_train

    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    bnt = {k: torch.from_numpy(v).requires_grad_(k in ("scale", "bias")) for k, v in bn.items()}
    w = None if weights is None else torch.from_numpy(weights[rows])
    y, st = batch_norm_train(xt, bnt, row_weights=w, group=dist.group.WORLD)
    (y * torch.from_numpy(grad_out[rows])).sum().backward()
    gs, gb = bnt["scale"].grad.clone(), bnt["bias"].grad.clone()
    dist.all_reduce(gs)
    dist.all_reduce(gb)
    return {"y": y.detach().numpy(), "mean": st.mean.detach().numpy(), "var": st.var.detach().numpy(),
            "var_unbiased": st.var_unbiased.detach().numpy(), "dx": xt.grad.numpy(), "dscale": gs.numpy(),
            "dbias": gb.numpy()}


def _steps(flat, x, y, hp_kw, steps, *, mask=None, group, rank, world, seed=7, gen_seed=None, num_classes=4,
           device="cpu"):
    """`steps` DP steps of make_train_step from `flat` on this rank's rows of
    (x, y[, mask]), the same batch each step, on `device`; the state and
    metrics, and the kernels' launches over the steps."""
    import torch

    from roomnet_tpu_torch.ops.kernels import _build
    from roomnet_tpu_torch.params.schema import variables_from_numpy
    from roomnet_tpu_torch.train import step as TS

    cfg = tiny(num_classes)
    hp = TS.TrainHParams(**hp_kw)
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    state = TS.init_train_state(variables_from_numpy(flat, cfg, device), hp)
    step = TS.make_train_step(hp, cfg, group=group)
    gen = torch.Generator(device).manual_seed(seed if gen_seed is None else gen_seed)
    xt, yt = torch.from_numpy(x[rows]).to(device), torch.from_numpy(y[rows]).to(device)
    mt = None if mask is None else torch.from_numpy(mask[rows]).to(device)
    since = _build.card_launches_since if torch.device(device).type == "cuda" else _build.launches_since
    before = _build.launch_counts()
    metrics = []
    for _ in range(steps):
        state, m = step(state, xt, yt, gen, mt)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state": numpy_state(state), "metrics": metrics,
            "launches": list(since(before, ("conv3x3", "relu6_pool_bn", "residual_bn", "dense_head")).values())}


def dp_steps(rank, world, workdir, flat, x, y, cases, faults=(), device="cpu"):
    """Each case of `cases` ({name: dict(hp=..., steps=..., mask=...)}) as DP
    steps over the world; then each fault of `faults` ((fault, case) pairs)
    planted and the case run again. Dropout cases also run with a
    per-rank-seeded generator (fault "per_rank_dropout_seeds")."""
    import importlib

    import torch.distributed as dist

    out = {}
    for name, c in cases.items():
        out[name] = _steps(flat, x, y, c["hp"], c["steps"], mask=c.get("mask"), group=dist.group.WORLD,
                           rank=rank, world=world, device=device)
    for fault, case in faults:
        c = cases[case]
        if fault == "per_rank_dropout_seeds":
            out[(fault, case)] = _steps(flat, x, y, c["hp"], c["steps"], mask=c.get("mask"),
                                        group=dist.group.WORLD, rank=rank, world=world, gen_seed=7 + rank)
            continue
        mod, old, new = FAULTS[fault]
        with mutated(importlib.import_module(mod), old, new):
            out[(fault, case)] = _steps(flat, x, y, c["hp"], c["steps"], mask=c.get("mask"),
                                        group=dist.group.WORLD, rank=rank, world=world)
    return out


def tp_run(flat, x, y, cfg_kw, hp_kw, steps, *, mask=None, mesh=None, seed=7, device="cpu"):
    """`steps` steps of make_train_step from `flat` on the same batch (x, y[,
    mask]) at the port's RoomNetConfig(**cfg_kw): with a mesh, this rank's
    rows and tensor parallelism over its 'model' axis (`variables_shardings(
    ..., tensor_parallel=True)`), without one the whole batch in this
    process. Returns the whole state (gathered over 'model'), this rank's
    local shapes of the trainable leaves and Adam moments, and the metrics."""
    import torch

    from roomnet_tpu_torch.models import roomnet as M
    from roomnet_tpu_torch.parallel import mesh as PM
    from roomnet_tpu_torch.parallel import tensor as PT
    from roomnet_tpu_torch.params.schema import variables_from_numpy
    from roomnet_tpu_torch.train import step as TS

    cfg = M.RoomNetConfig(**cfg_kw)
    hp = TS.TrainHParams(**hp_kw)
    state = TS.init_train_state(variables_from_numpy(flat, cfg, device), hp)
    rows, group, tp = slice(None), None, None
    if mesh is not None:
        n = x.shape[0] // mesh.shape["data"]
        rows = slice(mesh.coords[0] * n, (mesh.coords[0] + 1) * n)
        shardings = PM.variables_shardings(list(state.train_vars), mesh, tensor_parallel=True)
        state = PT.shard_train_state(state, shardings, mesh)
        group, tp = mesh.group("data"), PT.tensor_parallel(shardings, mesh)
    local = {**{k: tuple(v.shape) for k, v in state.train_vars.items()},
             **{f"opt/mu/{k}": tuple(v.shape) for k, v in state.opt_state.mu.items()},
             **{f"opt/nu/{k}": tuple(v.shape) for k, v in state.opt_state.nu.items()}}
    step = TS.make_train_step(hp, cfg, group=group, tp=tp)
    gen = torch.Generator(device).manual_seed(seed)
    xt, yt = torch.from_numpy(x[rows]).to(device), torch.from_numpy(y[rows]).to(device)
    mt = None if mask is None else torch.from_numpy(mask[rows]).to(device)
    metrics = []
    for _ in range(steps):
        state, m = step(state, xt, yt, gen, mt)
        metrics.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        state = PT.unshard_train_state(state, shardings, mesh)
    return {"state": numpy_state(state), "local_shapes": local, "metrics": metrics}


def tp_steps(rank, world, workdir, n_model, runs, faults=(), grads=None, device="cpu"):
    """Each run of `runs` ({name: tp_run's arguments}) on an (world //
    n_model, n_model) mesh; then each fault of `faults` ((fault, run) pairs,
    FAULTS keys) planted and the run again; with `grads`, `tp_grads`."""
    import importlib

    from roomnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world // n_model, n_model, devices=device)
    out = {name: tp_run(**r, mesh=mesh, device=device) for name, r in runs.items()}
    for fault, name in faults:
        mod, old, new = FAULTS[fault]
        with mutated(importlib.import_module(mod), old, new):
            out[(fault, name)] = tp_run(**runs[name], mesh=mesh, device=device)
    if grads is not None:
        out["grads"] = tp_grads(mesh, **grads)
    return out


def tp_grads(mesh, x, w, axis, v, k):
    """On this rank of the mesh's 'model' row: the gradient for this rank's
    slice of x (split along `axis`) of sum(gather_model(x_local) * w), and
    the gradient for v of sum((copy_to_model(v) @ k_local) ** 2), k_local
    this rank's columns of k."""
    import torch

    from roomnet_tpu_torch.parallel.tensor import copy_to_model, gather_model

    group, (n, i) = mesh.group("model"), (mesh.shape["model"], mesh.coords[1])
    c = x.shape[axis] // n
    xl = torch.from_numpy(x).narrow(axis, i * c, c).clone().requires_grad_()
    (gather_model(xl, axis, group) * torch.from_numpy(w)).sum().backward()
    cols = k.shape[1] // n
    vt = torch.from_numpy(v).requires_grad_()
    (copy_to_model(vt, group) @ torch.from_numpy(k[:, i * cols:(i + 1) * cols])).square().sum().backward()
    return {"gather": xl.grad.numpy(), "copy": vt.grad.numpy()}


def trainers(rank, world, workdir, runs):
    """Each run of `runs` ({name: dict(tc=TrainConfig kwargs, steps=...,
    classes=2, mesh=(n_data, n_model), may_raise=False, mesh_batch=())}) as
    `Trainer(...).train` on a mesh over the world, in order. Returns {name:
    {"state", "error", "stdout", "mesh_batch"}}."""
    import io

    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.train.loop import Phase, TrainConfig, Trainer

    out = {}
    for name, r in runs.items():
        mesh = make_mesh(*r.get("mesh", (world, 1)), devices="cpu")
        tc = dict(r["tc"])
        tc["phases"] = tuple(Phase(**p) for p in tc.get("phases", [dict(until_step=1 << 62, batch_size=8)]))
        tr = Trainer(TrainConfig(**tc), tiny(r.get("classes", 2)), device="cpu", mesh=mesh)
        res = {"mesh_batch": {b: tr._mesh_batch(b) for b in r.get("mesh_batch", ())}, "error": None, "state": None}
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                res["state"] = numpy_state(tr.train(total_steps=r["steps"], log_every=r.get("log_every", 100)))
        except Exception as e:  # noqa: BLE001 — a run that is expected to raise reports it
            if not r.get("may_raise"):
                raise
            res["error"] = f"{type(e).__name__}: {e}"
        res["stdout"] = buf.getvalue()
        out[name] = res
    return out


def dp_checkpoint(rank, world, workdir, flat, x, y, ckpt_dir):
    """One DP step, then the orbax store's collective save of the state from
    every rank: synchronous at step 1, asynchronous (then `wait`) as step 2."""
    import torch.distributed as dist

    from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore
    from roomnet_tpu_torch.params.schema import variables_from_numpy
    from roomnet_tpu_torch.train import step as TS
    from roomnet_tpu_torch.train.optimizer import flatten_opt_state

    hp = TS.TrainHParams(learn_rate=1e-3, num_steps=1000, l2_coeff=1e-4)
    cfg = tiny()
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    state = TS.init_train_state(variables_from_numpy(flat, cfg, "cpu"), hp)
    import torch

    state, _ = TS.make_train_step(hp, cfg, group=dist.group.WORLD)(state, torch.from_numpy(x[rows]),
                                                                  torch.from_numpy(y[rows]))
    opt = flatten_opt_state(state.opt_state)
    OrbaxCheckpointStore(ckpt_dir, async_save=False).save(state.variables(cfg), 1, suffix="dp", opt_state_flat=opt)
    store = OrbaxCheckpointStore(ckpt_dir, async_save=True)
    store.save(state.variables(cfg), 2, suffix="async", opt_state_flat=opt)
    store.wait()
    return numpy_state(state)


def mesh_server(rank, world, workdir, flat, requests, runs, kill_after=None, device="cpu"):
    """Each run of `runs` ({name: dict(reloads=[(step, flat)], fault=None
    or a FAULTS key, own_dirs=False)}), in order, as chip_smoke.mesh_serve
    of a batch-8 classifier of `flat` (tiny geometry, labels A-D) on
    `device` on a mesh over the world, with a model dir of its own under
    workdir (with own_dirs, one for each rank: rank 0's client saves into
    its own alone). With kill_after,
    rank 1 makes that many device calls, then writes its result and exits
    at once (os._exit: no shutdown, no STOP), as a lost rank does."""
    import importlib

    from chip_smoke import mesh_serve
    from roomnet_tpu_torch.infer.classify import RoomNetClassifier
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params.schema import variables_from_numpy

    cfg = tiny(4)
    out = {}
    for name, run in runs.items():
        clf = RoomNetClassifier(variables_from_numpy(flat, cfg, device), cfg, batch_size=8,
                                class_labels=["A", "B", "C", "D"], device=device, mesh=make_mesh(devices=device))
        if kill_after is not None and rank == 1:
            predict, calls = clf._predict, [0]

            def dying(variables, x):
                calls[0] += 1
                if calls[0] > kill_after:
                    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
                        pickle.dump({"killed_at_call": calls[0]}, f)
                    os._exit(0)
                return predict(variables, x)

            clf._predict = dying
        model_dir = os.path.join(workdir, f"models_{name}" + (f"_rank{rank}" if run.get("own_dirs") else ""))
        os.makedirs(model_dir, exist_ok=True)
        reloads = [(step, variables_from_numpy(f, cfg, "cpu")) for step, f in run.get("reloads", ())]
        fault = run.get("fault")
        with contextlib.ExitStack() as stack:
            if fault is not None:
                mod, old, new = FAULTS[fault]
                stack.enter_context(mutated(importlib.import_module(mod), old, new))
            out[name] = mesh_serve(clf, requests, model_dir=model_dir, reloads=reloads, ready_s=120.0)
        clf.close()
    return out


if __name__ == "__main__":
    main()
