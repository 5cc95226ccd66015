"""Training loop: the reference train.py main loop on the card (port of
roomnet_tpu/train/loop.py).

Preserved behaviours (reference train.py:115-158):
  * warm/cold dataset-list handling (`extract_fpaths`);
  * async feeders for train (shuffle+crop+augment) and val (plain);
  * every SAVE_FREQ steps (after the first): full val epoch, accuracy +
    per-class P/R/F, checkpoint named with the accuracy, stats appended to
    all_train_stats.json (same schema);
  * resume-latest on start; step counter restored.

And the JAX package's additions: the declarative phase schedule (the
reference README curriculum, batch 8->32->40->45 with dropout toggling and
the BN freeze, README.md:34-38, as data), `steps_per_call` windows, the
stall watchdog with its emergency checkpoint, the interrupt checkpoint.

On the card each step's batch is staged while the step before it runs: the
loop issues step i on the compute stream, then copies batch i+1 from a
fresh pinned tensor on a copy stream (`data/loader.py:to_device_async`),
and only then reads step i's loss, the host's only wait for the device;
step i+1 waits on the copy's event (`on_stream`). A step returns new
tensors and leaves the state it was given as it was (`train/step.py`), so
the last completed state that an emergency save writes is a reference,
taken only after the read that proves its step completed.

Data-parallel training over a mesh of ranks (`parallel/mesh.py`): every
rank runs this loop on its own card with the same config and seed, holds
its rows of each global batch and the replicated state, and the step
computes the single-device step of the global batch (`train/step.py`), as
the JAX Trainer's step jitted over a `P("data")` mesh does. With
feed_mode="replicated" every rank's feeder decodes the whole global batch
and the rank keeps its rows; with "sharded" it decodes its rows alone. Rank
0 alone writes npz checkpoints, prunes and writes the stats JSON; the orbax
backend (`params/orbax_io.py`, DCP) saves collectively from every rank.
Ranks along a model axis > 1 hold the same rows, as in the JAX Trainer,
which never applies `variables_shardings`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from .. import default_device
from ..data.dataset import extract_fpaths
from ..data.loader import TrainFeeder, on_stream, to_device_async
from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, forward, init_variables, normalize_bgr_uint8
from ..ops import blocks as B
from ..params import schema
from ..parallel import collectives as C
from ..params.checkpoint import CheckpointStore, merge_partial_restore
from .metrics import make_stats_entry
from .optimizer import flatten_opt_state, unflatten_opt_state
from .step import TrainHParams, TrainState, init_train_state, make_multi_train_step, make_train_step


@dataclasses.dataclass(frozen=True)
class Phase:
    """One leg of the training curriculum."""

    until_step: int  # phase is active while global step < until_step
    batch_size: int = 45
    dropout_enabled: bool = False
    dropout_rate: float = 0.35
    compute_bn_mean_var: bool = False
    update_bn_moving: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference train.py:26-41 constants, typed; plus phases. Every field of
    the JAX package's TrainConfig, so a config written for one package
    constructs in the other."""

    data_dir: str = "./data/REI-Dataset"
    train_list_fpath: str = "train_list.txt"
    val_list_fpath: str = "val_list.txt"
    # None = written next to train_list_fpath, never into the cwd.
    label_mappings_fpath: str | None = None
    stats_fpath: str = "all_train_stats.json"
    model_dir: str = "all_trained_models/trained_models"
    img_side: int = 224
    train_steps: int = 100_000
    save_freq: int = 10
    # Opt-in retention: after each save keep only the newest N regular
    # checkpoints (+ the best-accuracy one + all interrupt/stall markers).
    # None = keep-all, the reference contract (network.py:80).
    keep_checkpoints: int | None = None
    learn_rate: float = 2e-4
    l2_coeff: float = 6e-2
    val_batch_size: int = 64
    batches_per_queue: int = 40
    seed: int = 0
    restore_head: bool = True  # False = reference's fresh-dense-head restore
    phases: tuple[Phase, ...] = (Phase(until_step=1 << 62),)
    # Multi-rank input mode. "replicated": every rank's feeder decodes the
    # same global batch (the feeder is deterministic per seed) and the rank
    # keeps its rows; decode is repeated on every rank. "sharded": each rank
    # decodes only its rows (same epoch order and per-row augment draws, so
    # the union is the replicated batch row for row). Sharded masks a rank's
    # unreadable rows out of the loss instead of skipping the batch (a skip
    # on one rank would desync the collectives). Validation always feeds
    # replicated. Needs a mesh; no-op without one.
    feed_mode: str = "replicated"
    # Failure detection: warn when no step completes for this long
    # (0 disables). See utils/watchdog.py.
    stall_timeout_s: float = 600.0
    # Escalation when a stall fires: an emergency checkpoint of the last
    # completed state (suffix "stall", resumable like any other), and
    # optionally an interrupt of the main thread (KeyboardInterrupt -> the
    # loop's finally block closes the feeders).
    stall_checkpoint: bool = True
    stall_abort: bool = False
    # Validation BN mode. None = follow the active phase's
    # compute_bn_mean_var, the reference semantics (nn.infer runs with
    # training=compute_bn_mean_var, network.py:128-135, :193). True/False
    # force one mode.
    val_use_batch_stats: bool | None = None
    # Checkpoint backend: "npz" (portable flat files) or "orbax" (DCP
    # directories, asynchronous, saved collectively; params/orbax_io.py).
    ckpt_backend: str = "npz"
    # Optimizer steps per call of the step function; the window clamps at
    # phase and save boundaries, so validation cadence and the curriculum
    # are unchanged.
    steps_per_call: int = 1

    # README.md:34-38 curriculum as data (approximate step boundaries).
    # A deliberate divergence from the reference README, as in the JAX
    # package: phase 3 keeps update_bn_moving=True (the literal reading
    # collapsed to chance at the phase-4 boundary in a measured run).
    @staticmethod
    def reference_curriculum(total_steps: int = 160_000) -> tuple[Phase, ...]:
        q = total_steps // 4
        return (
            Phase(until_step=q, batch_size=8, compute_bn_mean_var=True, update_bn_moving=True),
            Phase(until_step=2 * q, batch_size=32, compute_bn_mean_var=True,
                  update_bn_moving=True, dropout_enabled=True, dropout_rate=0.3),
            Phase(until_step=3 * q, batch_size=40, compute_bn_mean_var=True,
                  update_bn_moving=True, dropout_enabled=True, dropout_rate=0.3),
            Phase(until_step=1 << 62, batch_size=45, compute_bn_mean_var=False,
                  update_bn_moving=False),
        )


def _cycle_pad(a: np.ndarray, n: int) -> np.ndarray:
    """Pad (or trim) axis 0 to exactly n rows by cycling existing rows — the
    one row-padding rule of the mesh-divisibility guard and the multi-step
    batch stacker."""
    if a.shape[0] >= n:
        return a[:n]
    idx = np.arange(n - a.shape[0]) % a.shape[0]
    return np.concatenate([a, a[idx]], axis=0)


def phase_at(phases: tuple[Phase, ...], step: int) -> Phase:
    for ph in phases:
        if step < ph.until_step:
            return ph
    return phases[-1]


class Trainer:
    """Owns the feeders, the step functions (one per phase signature) and
    the checkpoints. Runs on `device`, default the mesh's device, else
    `default_device()` (cuda, or raise). `mesh` (`parallel/mesh.py`): data
    parallelism over its ranks (module docstring); every rank constructs
    its Trainer alike and calls `train` alike."""

    def __init__(self, tc: TrainConfig = TrainConfig(), cfg: RoomNetConfig = DEFAULT_CONFIG,
                 device=None, mesh=None):
        if tc.img_side != cfg.im_side:
            raise ValueError(
                f"TrainConfig.img_side={tc.img_side} (data pipeline) != "
                f"cfg.im_side={cfg.im_side} (model geometry); pass matching "
                f"values — the CLI's --img-side sets both"
            )
        self.tc = tc
        self.cfg = cfg
        self.mesh = mesh
        self.device = default_device(device if device is not None or mesh is None else mesh.device)
        self._group = mesh.group("data") if mesh is not None else None
        self._rank = mesh.rank if mesh is not None else 0
        if tc.ckpt_backend == "orbax":
            from ..params.orbax_io import OrbaxCheckpointStore

            self.store = OrbaxCheckpointStore(tc.model_dir)
        else:
            self.store = CheckpointStore(tc.model_dir)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._compiled: dict = {}
        self._infer_fns: dict = {}
        self._invoked_sigs: set = set()  # (phase-key, shape) already run once

    # -- state ------------------------------------------------------------
    def init_state(self, rng: torch.Generator | None = None) -> TrainState:
        """Random init from `rng` (default: a generator on the device seeded
        with tc.seed), overlaid with the latest checkpoint in the model dir."""
        rng = rng if rng is not None else torch.Generator(self.device).manual_seed(self.tc.seed)
        variables = init_variables(rng, self.cfg)
        restored = self.store.load(cfg=self.cfg, restore_head=self.tc.restore_head, with_opt_state=True)
        hp = self._hp(phase_at(self.tc.phases, 0))
        if restored is None:
            print("No model found to restore from, initializing random weights")
            return init_train_state(variables, hp)
        var_flat, step, opt_flat = restored
        variables = merge_partial_restore(variables, var_flat, self.cfg)
        state = init_train_state(variables, hp)
        if opt_flat:
            opt_state = unflatten_opt_state(opt_flat, self.device)
            # Adam moments shaped for another geometry's head would crash the
            # step: start the optimizer fresh instead.
            mismatched = set(opt_state.mu) != set(state.train_vars) or any(
                tuple(opt_state.mu[k].shape) != tuple(v.shape) for k, v in state.train_vars.items())
            if mismatched:
                print("optimizer state shape-mismatched with model — fresh Adam state")
            else:
                state = state._replace(opt_state=opt_state)
        state = state._replace(step=torch.tensor(step, dtype=torch.int32, device=self.device))
        print(f"Model restored at step {step}")
        return state

    def _n_data(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape.get("data", 1))

    def _to_global(self, x: np.ndarray, *, leading_steps: bool = False, from_local: bool = False) -> np.ndarray:
        """This rank's rows of a host batch. Without a mesh, or for a sharded
        feed's batch (from_local: the rank decoded its rows alone), the batch
        itself; a replicated batch gives the rows of the rank's data
        coordinate. leading_steps: a (K, batch, ...) stack, rows on axis 1."""
        n = self._n_data()
        if n == 1 or from_local:
            return x
        axis = 1 if leading_steps else 0
        rows = x.shape[axis] // n
        d = self.mesh.coords[0]
        return x[:, d * rows:(d + 1) * rows] if leading_steps else x[d * rows:(d + 1) * rows]

    def _feed_rows(self, global_batch: int) -> tuple[int, int] | None:
        """This rank's row slice of the nominal batch under
        feed_mode="sharded" (None in replicated mode / without a mesh)."""
        if self.tc.feed_mode != "sharded" or self.mesh is None:
            return None
        n = self._n_data()
        if global_batch % n:
            raise ValueError(f"sharded feed: batch {global_batch} not divisible by the {n}-rank data axis")
        local, d = global_batch // n, self.mesh.coords[0]
        return (d * local, (d + 1) * local)

    def _feeder_batch(self, mesh_bs: int, n_usable: int) -> int:
        """Clamp the nominal batch to the dataset size BEFORE slicing it into
        sharded-feed rows (the feeder clamps its batch anyway; rows computed
        against the unclamped batch would fail its range check). The sharded
        global batch is rounded down to a multiple of lcm(ranks, data axis),
        so that it slices evenly, dropping fewer than that many tail rows per
        epoch, as the feeder's own epoch tail does."""
        eff = min(mesh_bs, n_usable)
        if self.tc.feed_mode == "sharded" and self.mesh is not None:
            import math

            quantum = math.lcm(self.mesh.size, self._n_data())
            eff = (eff // quantum) * quantum
            if eff == 0:
                raise ValueError(
                    f"sharded feed: {n_usable} usable rows cannot fill one batch quantum of {quantum} "
                    f"(ranks x data axis); use feed_mode='replicated' for datasets this small")
        return eff

    def _pad_for_mesh(self, x, y=None):
        """Pad a host batch up to a multiple of the 'data' axis by cycling
        rows: the guard for batches the feeder shrank (unreadable files
        dropped, a dataset smaller than the rounded batch)."""
        n = self._n_data()
        rem = x.shape[0] % n
        if rem == 0:
            return (x, y) if y is not None else x
        target = x.shape[0] + (n - rem)
        x = _cycle_pad(x, target)
        return x if y is None else (x, _cycle_pad(y, target))

    def _mesh_batch(self, batch_size: int) -> int:
        """Round a batch size UP to a multiple of the mesh's 'data' axis, so
        that every rank holds as many rows. Ceiling, never floor: the global
        batch must not shrink below the phase's size (45 on two ranks is
        46, not 44). No-op without a mesh."""
        n = self._n_data()
        if self.mesh is None:
            return batch_size
        rounded = max(n, -(-batch_size // n) * n)
        if rounded != batch_size:
            print(f"batch {batch_size} -> {rounded} (multiple of data axis {n})")
        return rounded

    def _hp(self, ph: Phase) -> TrainHParams:
        return TrainHParams(
            learn_rate=self.tc.learn_rate,
            num_steps=self.tc.train_steps,
            l2_coeff=self.tc.l2_coeff,
            dropout_enabled=ph.dropout_enabled,
            dropout_rate=ph.dropout_rate,
            compute_bn_mean_var=ph.compute_bn_mean_var,
            update_bn_moving=ph.update_bn_moving,
        )

    # -- step and validation functions ---------------------------------------
    def _step_fn(self, ph: Phase, *, multi: bool = False):
        """The phase's step function, or (multi=True) the K-steps-per-call
        variant (K from the input's leading axis; a (K, B) row mask marks
        the real rows)."""
        key = (ph.dropout_enabled, ph.dropout_rate, ph.compute_bn_mean_var, ph.update_bn_moving, multi)
        if key not in self._compiled:
            factory = make_multi_train_step if multi else make_train_step
            self._compiled[key] = factory(self._hp(ph), self.cfg, group=self._group)
        return self._compiled[key]

    def infer_fn(self, use_batch_stats: bool = False):
        """Validation forward: (train_vars, frozen_vars, x_uint8) -> argmax.
        `use_batch_stats=True` is the reference's validation during
        BN-unfrozen phases: `nn.infer` runs the same graph with
        training=compute_bn_mean_var (network.py:128-135, :193).

        Under a mesh, x_uint8 is this rank's rows; the predictions of every
        rank's rows come back on every rank (the JAX Trainer's replicated
        output), and batch statistics are the global batch's."""
        if use_batch_stats not in self._infer_fns:
            cfg, group = self.cfg, self._group

            def _infer(train_vars, frozen_vars, x_uint8):
                variables = schema.unflatten_variables({**train_vars, **frozen_vars}, cfg)
                with torch.no_grad(), B.full_f32():
                    logits = forward(variables, normalize_bgr_uint8(x_uint8), cfg,
                                     use_batch_stats=use_batch_stats, group=group)
                return C.gather(logits.argmax(dim=-1), group)

            self._infer_fns[use_batch_stats] = _infer
        return self._infer_fns[use_batch_stats]

    def run_validation(self, state: TrainState, val_reader: TrainFeeder, use_batch_stats: bool = False):
        """Infer one full val epoch (reference train.py:135-145 semantics:
        the last dequeued batch — first of the next epoch — is trimmed).

        As in the JAX package, the epoch-boundary check runs after at least
        one batch is inferred: the reference exits with zero predictions
        when the boundary flag rides the first dequeued batch (certain when
        the val set fits in one batch).
        """
        infer = self.infer_fn(use_batch_stats)
        x_val, y_val = val_reader.dequeue()
        y_vals = list(y_val)
        y_preds: list[int] = []
        epoch_flags = 0
        while True:
            if val_reader.last_batch_synthetic:
                # Fabricated rows (whole batch unreadable) must not count
                # toward accuracy: drop their labels and skip the infer.
                del y_vals[len(y_vals) - len(y_val):]
            else:
                n_real = x_val.shape[0]
                x_dev = torch.from_numpy(self._to_global(self._pad_for_mesh(x_val))).to(self.device)
                y_preds += list(infer(state.train_vars, state.frozen_vars, x_dev).cpu().numpy()[:n_real])
            x_val, y_val = val_reader.dequeue()
            y_vals += list(y_val)
            if val_reader.train_state["previous_epoch_done"]:
                epoch_flags += 1
                if y_preds:
                    break
                # Two whole epochs of synthetic batches: the val set is gone.
                # Raise rather than record a fake accuracy-0.0 entry.
                if epoch_flags >= 2:
                    raise RuntimeError(
                        "every validation batch in two epochs was unreadable — refusing to score "
                        "fabricated data"
                    )
        return y_vals[: len(y_preds)], y_preds

    # -- main loop ------------------------------------------------------------
    def train(self, total_steps: int | None = None, log_every: int = 1):
        tc = self.tc
        label_fpath = tc.label_mappings_fpath or os.path.join(
            os.path.dirname(tc.train_list_fpath) or ".", "label_mappings.json")
        train_txt, val_txt = extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath,
                                            label_fpath, seed=tc.seed)
        state = self.init_state()
        start_step = int(state.step)
        # `is not None`, not `or`: total_steps=0 runs 0 steps.
        total_steps = total_steps if total_steps is not None else tc.train_steps

        all_stats = []
        if os.path.isfile(tc.stats_fpath):
            try:
                with open(tc.stats_fpath) as f:
                    all_stats = json.load(f)
            except (json.JSONDecodeError, ValueError):
                # A corrupt stats file must not brick every resume (the
                # training state lives in the checkpoints): keep its bytes
                # aside and start a fresh history.
                quarantine = tc.stats_fpath + ".corrupt"
                os.replace(tc.stats_fpath, quarantine)
                print(f"stats file unparseable — moved to {quarantine}; starting a fresh stats history")

        n_usable = sum(1 for line in train_txt if str(line).strip())

        def feeder(batch_size: int) -> TrainFeeder:
            mesh_bs = self._feeder_batch(self._mesh_batch(batch_size), n_usable)
            return TrainFeeder(train_txt, batch_size=mesh_bs, batches_per_queue=tc.batches_per_queue,
                               shuffle=True, im_side=tc.img_side, random_crop=True, preprocess=True,
                               seed=tc.seed, rows=self._feed_rows(mesh_bs))

        ph = phase_at(tc.phases, start_step)
        train_reader = feeder(ph.batch_size)
        val_reader = TrainFeeder(val_txt, batch_size=self._mesh_batch(tc.val_batch_size), batches_per_queue=10,
                                 shuffle=False, im_side=tc.img_side, random_crop=False, preprocess=False,
                                 seed=tc.seed)
        from ..utils.watchdog import StepWatchdog

        # Stall escalation runs on the watchdog thread. The abort interrupt
        # fires FIRST: the emergency save reads the last completed state back
        # from the device, which may block on a hung device, and the
        # interrupt must not wait behind it.
        self._live_state = None  # last state whose step is known complete

        def _emergency_save(st, suffix: str):
            """Best-effort save of the last COMPLETED state (stall or
            interrupt). Rank 0 with npz: a normal resumable save into the
            model dir. Otherwise (the orbax backend, or rank > 0): a
            collective save cannot be driven from the watchdog thread or an
            exception handler without hanging the other ranks, so a local
            npz dump under model_dir/emergency/ instead."""
            if st is None:
                print(f"{suffix}: no completed step state yet — nothing to dump")
                return
            if tc.ckpt_backend != "orbax" and self._rank == 0:
                path = self.store.save(st.variables(self.cfg), int(st.step), suffix=suffix,
                                       opt_state_flat=flatten_opt_state(st.opt_state))
                print(f"{suffix}: emergency checkpoint written to {path}")
                return
            dump = CheckpointStore(os.path.join(tc.model_dir, "emergency"))
            path = dump.save(st.variables(self.cfg), int(st.step), suffix=f"{suffix}-rank{self._rank}",
                             opt_state_flat=flatten_opt_state(st.opt_state))
            print(f"{suffix}: collective checkpointing unavailable here (backend={tc.ckpt_backend}, "
                  f"rank={self._rank}) — local npz emergency dump written to {path}; restore it with "
                  "CheckpointStore.load")

        self._stall_aborting = False
        # Set when the watchdog thread's stall save finishes: with stall_abort
        # the main thread unwinds on the interrupt while the (daemon) watchdog
        # thread may still be writing, so the interrupt handler below waits
        # for it, bounded.
        self._stall_save_done = threading.Event()

        def _on_stall(info):
            if tc.stall_abort:
                # Flag BEFORE interrupting: the interrupt handler must not run
                # a second save against the device the detector suspects.
                self._stall_aborting = True
                import _thread

                _thread.interrupt_main()
            if tc.stall_checkpoint:
                try:
                    _emergency_save(self._live_state, "stall")
                finally:
                    self._stall_save_done.set()
            else:
                self._stall_save_done.set()

        watchdog = StepWatchdog(tc.stall_timeout_s, on_stall=_on_stall) if tc.stall_timeout_s else None
        if watchdog:
            watchdog.start()
        # Dropout masks: one generator for the run, seeded tc.seed + 1 (a
        # resume restarts it, as the JAX package restarts its key).
        rng = torch.Generator(self.device).manual_seed(tc.seed + 1)
        pending = None  # the next window's batch, staged while a step runs
        consec_synthetic = 0  # sharded feed: batches in a row whose slice was all unreadable

        def fetch_host_batch():
            nonlocal consec_synthetic
            if train_reader.rows is not None:
                # Sharded feed: never skip — a skip on one rank would desync
                # the ranks' batch streams and hang the collectives. An
                # unreadable local slice weighs nothing through the row mask
                # (and a batch with no real row on any rank is a state no-op
                # in the step). A slice unreadable for a whole epoch means
                # this rank's files are gone: raise, as the replicated path.
                x, y = train_reader.dequeue()
                lo, hi = train_reader.rows
                n_real = 0 if train_reader.last_batch_synthetic else x.shape[0]
                consec_synthetic = consec_synthetic + 1 if n_real == 0 else 0
                if consec_synthetic > max(train_reader.batches_per_epoch, 1):
                    raise RuntimeError(
                        "sharded feed: every batch in a full epoch of this rank's row slice was unreadable "
                        "— dataset files missing or corrupt on this host")
                return _cycle_pad(x, hi - lo), _cycle_pad(y, hi - lo), n_real
            # Skip synthetic batches (whole batch unreadable — fabricated zeros
            # labelled class 0), bounded by one epoch of consecutive misses,
            # after which the dataset is plainly gone.
            for _ in range(max(train_reader.batches_per_epoch, 1) + 1):
                x, y = train_reader.dequeue()
                if not train_reader.last_batch_synthetic:
                    n_real = x.shape[0]  # before the mesh's row-cycling pad
                    x, y = self._pad_for_mesh(x, y)
                    return x, y, n_real
                print("skipping synthetic batch (all files unreadable)")
            raise RuntimeError(
                "every batch in a full epoch was unreadable — dataset files "
                "missing or corrupt; refusing to train on fabricated zeros"
            )

        def fetch_next(k: int):
            """k host batches, staged to the device as this rank's rows:
            (x, y) for k == 1 (a shrunk batch keeps its shape), with a (B,)
            float mask of the real rows where rows were padded (the mesh's
            divisibility pad) and always under the sharded feed; for k > 1
            (x, y, mask) stacked to (k, B, ...), every batch cycle-padded to
            the nominal size and the mask (k, B), so padding carries no
            gradient weight, as with k == 1."""
            sharded = train_reader.rows is not None
            if k == 1:
                x, y, n_real = fetch_host_batch()
                arrays = (x, y)
                if sharded or x.shape[0] != n_real:
                    mask = np.zeros((x.shape[0],), np.float32)
                    mask[:n_real] = 1.0
                    arrays = (x, y, mask)
                return to_device_async([self._to_global(a, from_local=sharded) for a in arrays],
                                       self.device, self._copy_stream)
            if sharded:
                n = train_reader.rows[1] - train_reader.rows[0]
            else:
                # The feeder may have clamped its batch below the mesh's
                # rounding (a dataset smaller than the phase batch): pad the
                # rows up to the data-axis multiple, masked out below.
                d = self._n_data()
                n = -(-train_reader.batch_size // d) * d
            triples = [fetch_host_batch() for _ in range(k)]
            x = np.stack([_cycle_pad(t[0], n) for t in triples])
            y = np.stack([_cycle_pad(t[1], n) for t in triples])
            mask = np.zeros((k, n), np.float32)
            for j, t in enumerate(triples):
                mask[j, : min(t[2], n)] = 1.0
            return to_device_async([self._to_global(a, leading_steps=True, from_local=sharded)
                                    for a in (x, y, mask)], self.device, self._copy_stream)

        end_step = start_step + total_steps

        def window(i: int) -> int:
            """Steps for the next call: steps_per_call clamped at the run end,
            the next phase boundary and the next save/validation point."""
            nxt = end_step
            for p in tc.phases:
                if i < p.until_step:
                    nxt = min(nxt, p.until_step)
                    break
            if tc.save_freq > 0:
                nxt = min(nxt, ((i // tc.save_freq) + 1) * tc.save_freq)
            return max(1, min(tc.steps_per_call, nxt - i))

        # Preemption safety: SIGTERM checkpoints like Ctrl-C does. Signals
        # only deliver to the main thread; skip elsewhere (tests).
        import signal

        old_sigterm = None
        if threading.current_thread() is threading.main_thread():
            def _sigterm(signum, frame):
                raise KeyboardInterrupt("SIGTERM")

            old_sigterm = signal.signal(signal.SIGTERM, _sigterm)
        try:
            it = start_step
            while it < end_step:
                new_ph = phase_at(tc.phases, it)
                if new_ph.batch_size != ph.batch_size:
                    train_reader.close()
                    pending = None
                    train_reader = feeder(new_ph.batch_size)
                ph = new_ph
                # save_freq=0 disables the save/validation cadence.
                if tc.save_freq > 0 and it % tc.save_freq == 0 and it > start_step:
                    val_bn = ph.compute_bn_mean_var if tc.val_use_batch_stats is None else tc.val_use_batch_stats
                    # Validation (with its first forward's kernel build) can
                    # exceed the stall timeout: not a stall.
                    if watchdog:
                        watchdog.pause()
                    y_vals, y_preds = self.run_validation(state, val_reader, use_batch_stats=val_bn)
                    if watchdog:
                        watchdog.resume()
                    entry = make_stats_entry(int(state.step), y_vals, y_preds)
                    # The npz store is a plain file write: every rank saving
                    # would race identical bytes through one tmp path, so rank
                    # 0 alone writes (the state is replicated). The orbax
                    # backend's save is collective: every rank calls it.
                    is_rank0 = self._rank == 0
                    if tc.ckpt_backend == "orbax" or is_rank0:
                        self.store.save(state.variables(self.cfg), int(state.step),
                                        suffix=str(entry["accuracy"]),
                                        opt_state_flat=flatten_opt_state(state.opt_state))
                    if tc.keep_checkpoints and is_rank0:
                        # Prune sees finished checkpoints only: an async write
                        # lands first.
                        if hasattr(self.store, "wait"):
                            self.store.wait()
                        self.store.prune(tc.keep_checkpoints)
                    if is_rank0:
                        all_stats.append(entry)
                        # Atomic tmp+rename: an unclean death mid-write must
                        # not leave truncated JSON for the next resume.
                        tmp = tc.stats_fpath + ".tmp"
                        with open(tmp, "w") as f:
                            json.dump(all_stats, f, indent=4, sort_keys=True)
                        os.replace(tmp, tc.stats_fpath)
                        print(f"Validated at step {int(state.step)}: acc {entry['accuracy']:.4f}")
                k = window(it)
                staged = pending if pending is not None else fetch_next(k)
                pending = None
                x, y, *mk = on_stream(staged)
                t0 = time.perf_counter()
                # The first call of a (phase, batch-shape) signature builds
                # the CUDA kernels on a fresh checkout (nvcc, tens of
                # seconds): an expected silence the watchdog must not
                # escalate on.
                sig = (ph.dropout_enabled, ph.dropout_rate, ph.compute_bn_mean_var, ph.update_bn_moving,
                       tuple(x.shape), bool(mk))
                first_call = sig not in self._invoked_sigs
                if first_call and watchdog:
                    watchdog.pause()
                if k > 1:
                    state, metrics = self._step_fn(ph, multi=True)(state, x, y, rng, mk[0])
                elif mk:  # masked rows (sharded feed, or the mesh's pad)
                    state, metrics = self._step_fn(ph)(state, x, y, rng, mk[0])
                else:
                    state, metrics = self._step_fn(ph)(state, x, y, rng)
                if first_call:
                    self._invoked_sigs.add(sig)
                    if watchdog:
                        # Resume only once the first result has landed.
                        float(metrics["loss"])
                        watchdog.resume()
                # While the step runs, stage the next window's batch — unless
                # a batch-size phase boundary lands there (the rebuilt feeder
                # would discard it).
                if it + k < end_step and phase_at(tc.phases, it + k).batch_size == ph.batch_size:
                    pending = fetch_next(window(it + k))
                # Log when a multiple of log_every falls INSIDE this window
                # [it, it+k) — (-it) % log_every is its offset.
                if (-it) % log_every < k:
                    # float() waits for the step: only then is the heartbeat
                    # meaningful and the state known complete, safe for the
                    # emergency save (the next step leaves it as it is).
                    loss, lr = float(metrics["loss"]), float(metrics["learn_rate"])
                    self._live_state = state
                    if watchdog:
                        watchdog.beat(it)
                    print(f"Step {int(state.step)} loss = {loss:.5f} learn_rate = {lr:.3e} "
                          f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
                it += k
        except KeyboardInterrupt:
            # Interrupt (Ctrl-C, SIGTERM): save the last COMPLETED state
            # before propagating — except when the interrupt came from the
            # stall escalation, whose watchdog-thread save is running: wait
            # for it, bounded, instead of exiting and killing it mid-write.
            if not self._stall_aborting:
                _emergency_save(self._live_state, "interrupt")
            elif tc.stall_checkpoint and not self._stall_save_done.wait(timeout=60.0):
                print("stall checkpoint still blocked on the device after 60 s — abandoning it (best-effort)")
            raise
        finally:
            if old_sigterm is not None:
                signal.signal(signal.SIGTERM, old_sigterm)
            if watchdog:
                watchdog.stop()
            if hasattr(self.store, "wait"):
                self.store.wait()  # an async (orbax) save lands before the run returns
            train_reader.close()
            val_reader.close()
        return state
