"""The port's training loop (roomnet_tpu_torch/train/loop.py), its watchdog
and its `train` subcommand, on the CPU at tests/tiny.py's geometry.

Every behaviour of tests/test_train_loop.py that needs no mesh, sharded feed
or orbax store, run on the port (those twelve run on two ranks in
tests/test_torch_train_loop_dp.py), and every behaviour of
tests/test_watchdog.py. Then: the Trainer against hand-driven steps
(chip_smoke.hand_driven, the gate of chip_smoke.py phase 9 (b)), the stall
checkpoint against the hand-driven state of its step, the `train` parser
against the JAX parser, and one CLI run. Parity with the JAX Trainer is in
tests/test_torch_train_loop_parity.py.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from chip_smoke import hand_driven, record_losses, state_gap, state_tensors, tiny_config
from roomnet_tpu import cli as jcli
from roomnet_tpu_torch import cli as tcli
from roomnet_tpu_torch.data.dataset import extract_fpaths
from roomnet_tpu_torch.params.checkpoint import CheckpointStore
from roomnet_tpu_torch.train.loop import Phase, TrainConfig, Trainer, phase_at
from roomnet_tpu_torch.utils.watchdog import StepWatchdog

cv2 = pytest.importorskip("cv2")
CFG2 = dataclasses.replace(tiny_config(), num_classes=2)


@pytest.fixture
def data_dir(tmp_path):
    rng = np.random.RandomState(0)
    for cls, base in [("Kitchen", 40), ("Bedroom", 200)]:
        d = tmp_path / "data" / cls
        d.mkdir(parents=True)
        for i in range(10):
            im = np.clip(rng.randint(base - 30, base + 30, (40, 48, 3)), 0, 255)
            cv2.imwrite(str(d / f"im_{i}.png"), im.astype(np.uint8))
    return tmp_path


def _tc(tmp_path, **kw):
    base = dict(
        data_dir=str(tmp_path / "data"),
        train_list_fpath=str(tmp_path / "train_list.txt"),
        val_list_fpath=str(tmp_path / "val_list.txt"),
        stats_fpath=str(tmp_path / "stats.json"),
        model_dir=str(tmp_path / "models"),
        img_side=CFG2.im_side,
        train_steps=1000,
        save_freq=5,
        val_batch_size=2,
        learn_rate=1e-3,
        l2_coeff=1e-4,
        phases=(Phase(until_step=1 << 62, batch_size=4),),
    )
    base.update(kw)
    return TrainConfig(**base)


def _trainer(tc):
    return Trainer(tc, CFG2, device="cpu")


def _slowed(tr, seconds):
    """Each step of `tr` sleeps `seconds` on the host before it runs."""
    orig = tr._step_fn

    def slow_step_fn(ph, **kw):
        fn = orig(ph, **kw)

        def wrapped(*a):
            time.sleep(seconds)
            return fn(*a)

        return wrapped

    tr._step_fn = slow_step_fn


# -- the behaviours of tests/test_train_loop.py ---------------------------------


def test_trainer_rejects_geometry_mismatch(tmp_path):
    with pytest.raises(ValueError, match="img_side"):
        Trainer(_tc(tmp_path, img_side=CFG2.im_side + 8), CFG2, device="cpu")


def test_trainer_end_to_end_and_resume(data_dir):
    tc = _tc(data_dir)
    state = _trainer(tc).train(total_steps=11, log_every=100)
    assert int(state.step) == 11
    stats = json.load(open(tc.stats_fpath))
    assert [s["step"] for s in stats] == [5, 10]
    assert set(stats[0]) == {"step", "accuracy", "precisions", "recalls", "f-scores"}
    ckpts = os.listdir(tc.model_dir)
    assert len(ckpts) == 2 and all(c.startswith("roomnet--") for c in ckpts)
    # the label mapping lands next to the list files, never in the cwd
    assert os.path.exists(os.path.join(os.path.dirname(tc.train_list_fpath), "label_mappings.json"))
    state2 = _trainer(tc).train(total_steps=3, log_every=100)
    assert int(state2.step) == 13  # resumed at the step-10 checkpoint


def test_trainer_multi_step_per_dispatch(data_dir):
    """steps_per_call=4 does not divide save_freq=5 or the phase edge at 7:
    windows clamp, the validations land at 5 and 10, resume works."""
    tc = dataclasses.replace(
        _tc(data_dir, phases=(Phase(until_step=7, batch_size=4),
                              Phase(until_step=1 << 62, batch_size=4, dropout_enabled=True, dropout_rate=0.2))),
        steps_per_call=4)
    tr = _trainer(tc)
    calls = []
    orig = tr._step_fn

    def spy(ph, **kw):
        fn = orig(ph, **kw)

        def run(state, x, *a):
            calls.append(tuple(x.shape[:-3]))
            return fn(state, x, *a)
        return run

    tr._step_fn = spy
    state = tr.train(total_steps=13, log_every=1)
    assert int(state.step) == 13
    assert calls == [(4, 4), (4,), (2, 4), (3, 4), (3, 4)]  # 0-4, 4 (one step), 5-7, 7-10, 10-13
    assert [s["step"] for s in json.load(open(tc.stats_fpath))] == [5, 10]
    state2 = _trainer(tc).train(total_steps=4, log_every=1)
    assert int(state2.step) == 14


def test_trainer_refuses_fully_unreadable_dataset(data_dir, tmp_path):
    tc = _tc(data_dir, save_freq=1000)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(tmp_path / "labels.json"))
    for cls in ("Kitchen", "Bedroom"):
        for p in (data_dir / "data" / cls).iterdir():
            p.write_text("corrupted")
    with pytest.raises(RuntimeError, match="unreadable"):
        _trainer(tc).train(total_steps=3, log_every=100)


def test_phase_schedule_selection():
    phases = TrainConfig.reference_curriculum(total_steps=400)
    assert [phase_at(phases, s).batch_size for s in (0, 150, 250, 399, 10 ** 9)] == [8, 32, 40, 45, 45]
    assert phase_at(phases, 0).compute_bn_mean_var
    assert not phase_at(phases, 399).compute_bn_mean_var
    for step in (0, 150, 250):
        ph = phase_at(phases, step)
        assert ph.compute_bn_mean_var and ph.update_bn_moving, step


def test_trainer_curriculum_phase_transitions(data_dir):
    phases = (
        Phase(until_step=4, batch_size=2, compute_bn_mean_var=True, update_bn_moving=True),
        Phase(until_step=8, batch_size=4, dropout_enabled=True, dropout_rate=0.2, compute_bn_mean_var=True,
              update_bn_moving=False),
        Phase(until_step=1 << 62, batch_size=3, compute_bn_mean_var=False),
    )
    tr = _trainer(_tc(data_dir, phases=phases, save_freq=6))
    shapes = []
    orig = tr._step_fn

    def spy(ph, **kw):
        fn = orig(ph, **kw)

        def run(state, x, *a):
            shapes.append(x.shape[0])
            return fn(state, x, *a)
        return run

    tr._step_fn = spy
    state = tr.train(total_steps=10, log_every=100)
    assert int(state.step) == 10
    assert shapes == [2] * 4 + [4] * 4 + [3] * 2


def test_trainer_bitwise_deterministic(data_dir):
    """Two fresh runs with the same seed, dropout on, give equal parameters."""
    def run(tag):
        tc = _tc(data_dir, phases=(Phase(until_step=1 << 62, batch_size=4, dropout_enabled=True,
                                         dropout_rate=0.3),),
                 model_dir=str(data_dir / f"models_{tag}"), stats_fpath=str(data_dir / f"stats_{tag}.json"))
        return _trainer(tc).train(total_steps=6, log_every=100).train_vars

    a, b = run("a"), run("b")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_validation_single_batch_epoch_counts_predictions(data_dir):
    from roomnet_tpu_torch.data.loader import TrainFeeder

    tc = _tc(data_dir)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(data_dir / "labels.json"), seed=0)
    tr = _trainer(tc)
    state = tr.init_state()
    with open(tc.val_list_fpath) as f:
        n_val = len([l for l in f if l.strip()])
    with TrainFeeder(open(tc.val_list_fpath).readlines(), batch_size=64, batches_per_queue=4, shuffle=False,
                     im_side=CFG2.im_side, random_crop=False, preprocess=False) as val_reader:
        assert val_reader.batches_per_epoch == 1
        for _ in range(3):
            y_vals, y_preds = tr.run_validation(state, val_reader)
            assert len(y_preds) >= n_val - 1 and len(y_vals) == len(y_preds)


def test_validation_bn_mode_follows_phase(data_dir):
    from roomnet_tpu_torch.models.roomnet import forward, normalize_bgr_uint8

    bn_phase = (Phase(until_step=1 << 62, batch_size=4, compute_bn_mean_var=True, update_bn_moving=True),)
    tc = _tc(data_dir, phases=bn_phase)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(data_dir / "labels_bn.json"), seed=0)
    tr = _trainer(tc)
    state = tr.init_state()
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (4, 32, 32, 3)).astype(np.uint8))
    for mode in (False, True):
        got = tr.infer_fn(mode)(state.train_vars, state.frozen_vars, x)
        want = forward(state.variables(CFG2), normalize_bgr_uint8(x), CFG2, use_batch_stats=mode)
        assert torch.equal(got, want.argmax(-1))
    tc2 = dataclasses.replace(tc, model_dir=str(data_dir / "models_bnphase"),
                              stats_fpath=str(data_dir / "stats_bnphase.json"), save_freq=3)
    tr2 = _trainer(tc2)
    tr2.train(total_steps=4, log_every=100)
    assert True in tr2._infer_fns
    tc3 = dataclasses.replace(tc2, model_dir=str(data_dir / "models_bnforce"),
                              stats_fpath=str(data_dir / "stats_bnforce.json"), val_use_batch_stats=False)
    tr3 = _trainer(tc3)
    tr3.train(total_steps=4, log_every=100)
    assert True not in tr3._infer_fns and False in tr3._infer_fns


def test_stall_writes_emergency_checkpoint(data_dir):
    """A stalled step triggers an emergency checkpoint (suffix 'stall') of
    the last completed state: the hand-driven state of its step, resumable."""
    tc = _tc(data_dir, model_dir=str(data_dir / "models_stall"), stats_fpath=str(data_dir / "stats_stall.json"),
             save_freq=1000, stall_timeout_s=0.25)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(data_dir / "labels.json"), seed=0)
    tr = _trainer(tc)
    states, _ = hand_driven(tr, 3)
    _slowed(tr, 1.0)
    tr.train(total_steps=3, log_every=1)
    stall = [p for s, sfx, p in tr.store.list_checkpoints() if sfx == "stall"]
    assert stall, os.listdir(tc.model_dir)
    for path in stall:
        with np.load(path) as f:
            saved = dict(f)
        step = int(saved["meta/step"])
        assert state_gap(saved, state_tensors(states[step - 1]), 1e-6) == 0.0
    restored = tr.store.load(cfg=CFG2, with_opt_state=True)
    assert restored is not None and restored[1] >= 1


def test_interrupt_saves_emergency_checkpoint(data_dir):
    tc = _tc(data_dir, model_dir=str(data_dir / "models_intr"), stats_fpath=str(data_dir / "stats_intr.json"),
             save_freq=1000, stall_timeout_s=0)
    tr = _trainer(tc)
    orig = tr._step_fn
    calls = {"n": 0}

    def interrupting_step_fn(ph, **kw):
        fn = orig(ph, **kw)

        def wrapped(*a):
            calls["n"] += 1
            if calls["n"] == 3:
                raise KeyboardInterrupt
            return fn(*a)

        return wrapped

    tr._step_fn = interrupting_step_fn
    with pytest.raises(KeyboardInterrupt):
        tr.train(total_steps=10, log_every=1)
    assert [s for s, sfx, _ in tr.store.list_checkpoints() if sfx == "interrupt"] == [2]
    restored = tr.store.load(cfg=CFG2, with_opt_state=True)
    assert restored is not None and restored[1] == 2


def test_stall_abort_interrupts_training(data_dir):
    """stall_abort=True: the watchdog interrupts the main thread; the loop's
    finally block still cleans up. Step 0 sleeps inside the first-call pause;
    the stall fires during step 1, far short of 5 slow steps."""
    tc = _tc(data_dir, model_dir=str(data_dir / "models_abort"), stats_fpath=str(data_dir / "stats_abort.json"),
             save_freq=1000, stall_timeout_s=0.25, stall_abort=True)
    tr = _trainer(tc)
    _slowed(tr, 1.5)
    t0 = time.monotonic()
    with pytest.raises(KeyboardInterrupt):
        tr.train(total_steps=5, log_every=1)
    assert time.monotonic() - t0 < 6.0


def test_stall_abort_waits_for_watchdog_checkpoint(data_dir):
    """stall_abort + stall_checkpoint: the unwinding main thread waits
    (bounded) for the watchdog thread's slowed save."""
    tc = _tc(data_dir, model_dir=str(data_dir / "models_abort_ckpt"),
             stats_fpath=str(data_dir / "stats_abort_ckpt.json"), save_freq=1000, stall_timeout_s=0.25,
             stall_abort=True, stall_checkpoint=True)
    tr = _trainer(tc)
    _slowed(tr, 1.5)
    real_save = tr.store.save

    def slow_save(*a, **kw):
        time.sleep(1.5)  # longer than the main thread's unwind
        return real_save(*a, **kw)

    tr.store.save = slow_save
    with pytest.raises(KeyboardInterrupt):
        tr.train(total_steps=5, log_every=1)
    assert [c for c in os.listdir(tc.model_dir) if "--stall--" in c], os.listdir(tc.model_dir)


def test_trainer_save_freq_zero_and_total_steps_zero(data_dir):
    tc = _tc(data_dir, save_freq=0)
    assert int(_trainer(tc).train(total_steps=3, log_every=100).step) == 3
    assert not os.path.exists(tc.stats_fpath)
    assert int(_trainer(tc).train(total_steps=0, log_every=100).step) == 0


def test_trainer_corrupt_stats_file_quarantined(data_dir):
    tc = _tc(data_dir)
    with open(tc.stats_fpath, "w") as f:
        f.write('[{"step": 1, "accuracy"')  # truncated mid-write
    assert int(_trainer(tc).train(total_steps=6, log_every=100).step) == 6
    assert os.path.exists(tc.stats_fpath + ".corrupt")
    with open(tc.stats_fpath) as f:
        stats = json.load(f)
    assert stats and all("accuracy" in e for e in stats)


def test_keep_checkpoints_retention(data_dir):
    tc = _tc(data_dir, keep_checkpoints=1)
    assert int(_trainer(tc).train(total_steps=11, log_every=100).step) == 11
    steps = [s for s, _, _ in CheckpointStore(tc.model_dir).list_checkpoints()]
    assert 10 in steps and len(steps) <= 2, steps
    assert int(_trainer(tc).train(total_steps=2, log_every=100).step) == 12


# -- the behaviours of tests/test_watchdog.py -----------------------------------


def test_watchdog_fires_on_stall_and_recovers():
    fired = []
    wd = StepWatchdog(timeout_s=0.3, on_stall=fired.append, check_interval_s=0.05)
    with wd:
        wd.beat(1)
        time.sleep(1.0)
        assert wd.stall_count >= 1
        n = wd.stall_count
        wd.beat(2)
        time.sleep(0.15)
        assert wd.stall_count == n
    assert fired and fired[0]["last_step"] == 1


def test_watchdog_quiet_when_beating():
    wd = StepWatchdog(timeout_s=2.0, check_interval_s=0.05)
    with wd:
        for i in range(6):
            wd.beat(i)
            time.sleep(0.05)
    assert wd.stall_count == 0


def test_watchdog_pause_suppresses_stalls():
    fired = []
    wd = StepWatchdog(timeout_s=0.3, on_stall=fired.append, check_interval_s=0.05)
    with wd:
        wd.pause()
        time.sleep(0.8)
        assert wd.stall_count == 0
        wd.resume()
        time.sleep(0.15)
        assert wd.stall_count == 0
        time.sleep(0.6)
        assert wd.stall_count >= 1
    assert fired


def test_optimizer_state_continuity_across_resume(tmp_path):
    """Resume restores Adam m/v and count: 2 steps, checkpoint, restore, 2
    more equal 4 uninterrupted steps."""
    from roomnet_tpu_torch.models.roomnet import init_variables
    from roomnet_tpu_torch.params import schema
    from roomnet_tpu_torch.train.optimizer import flatten_opt_state, unflatten_opt_state
    from roomnet_tpu_torch.train.step import TrainHParams, init_train_state, make_train_step

    hp = TrainHParams(learn_rate=1e-3, l2_coeff=0.0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3), np.uint8))
    y = torch.from_numpy(rng.randint(0, 2, (4,)).astype(np.int32))
    step = make_train_step(hp, CFG2)

    def fresh():
        return init_train_state(init_variables(torch.Generator().manual_seed(0), CFG2), hp)

    s = fresh()
    for _ in range(4):
        s, _ = step(s, x, y)
    s2 = fresh()
    for _ in range(2):
        s2, _ = step(s2, x, y)
    store = CheckpointStore(str(tmp_path))
    store.save(s2.variables(CFG2), 2, opt_state_flat=flatten_opt_state(s2.opt_state))
    var_flat, loaded_step, opt_flat = store.load(cfg=CFG2, with_opt_state=True)
    assert loaded_step == 2
    s3 = init_train_state(schema.variables_from_numpy(var_flat, CFG2, "cpu"), hp)
    # the step too, as Trainer.init_state restores it: the LR schedule's clock
    s3 = s3._replace(opt_state=unflatten_opt_state(opt_flat), step=torch.tensor(loaded_step, dtype=torch.int32))
    for _ in range(2):
        s3, _ = step(s3, x, y)
    for k in s.train_vars:
        np.testing.assert_allclose(s3.train_vars[k].numpy(), s.train_vars[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# -- the port's own gates --------------------------------------------------------


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_trainer_matches_hand_driven_steps(data_dir, steps_per_call):
    """chip_smoke.py phase 9 (b) at tiny: Trainer.train(6) with save_freq 5
    equals six hand-driven steps (params, BN stats, Adam state, losses), one
    stats entry at step 5 and its acc-named checkpoint."""
    tc = _tc(data_dir, steps_per_call=steps_per_call)
    extract_fpaths(tc.data_dir, tc.train_list_fpath, tc.val_list_fpath, str(data_dir / "labels.json"), seed=0)
    tr = _trainer(tc)
    states, want_losses = hand_driven(tr, 6)
    losses = record_losses(tr)
    state = tr.train(total_steps=6, log_every=1)
    assert state_gap(state_tensors(state), state_tensors(states[-1]), 1e-5) <= 1e-5
    if steps_per_call == 1:
        np.testing.assert_allclose([float(v) for v in losses], want_losses, rtol=1e-5, atol=1e-5)
    stats = json.load(open(tc.stats_fpath))
    assert [s["step"] for s in stats] == [5]
    assert [os.path.basename(p) for _, _, p in tr.store.list_checkpoints()] == [
        f"roomnet--{stats[0]['accuracy']}--5.npz"]


def test_trainer_refuses_what_waits_for_scale_out(tmp_path):
    """Scale-out is ported: a Trainer takes a mesh (its device and data
    group), the sharded feed (a no-op without a mesh, as in the JAX package)
    and the orbax (DCP) store. The mesh's 'model' group exists (tensor
    parallelism runs in the step, `make_train_step(..., tp=...)`), and the
    Trainer, like the JAX Trainer, runs no collective over it."""
    from roomnet_tpu_torch.parallel import distributed
    from roomnet_tpu_torch.parallel.mesh import make_mesh
    from roomnet_tpu_torch.params.orbax_io import OrbaxCheckpointStore

    try:
        mesh = make_mesh(devices="cpu")
        tr = Trainer(_tc(tmp_path), CFG2, mesh=mesh)
        assert tr.device == torch.device("cpu") and tr._group is mesh.group("data")
        assert tr._mesh_batch(45) == 45 and tr._feed_rows(4) is None
        assert Trainer(_tc(tmp_path, feed_mode="sharded"), CFG2, device="cpu")._feed_rows(4) is None
        store = Trainer(_tc(tmp_path, ckpt_backend="orbax"), CFG2, device="cpu").store
        assert isinstance(store, OrbaxCheckpointStore)
        assert torch.distributed.get_world_size(mesh.group("model")) == 1
    finally:
        distributed.shutdown()


def test_trainer_without_a_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tc(tmp_path), CFG2)


def test_train_config_fields_are_the_jax_packages():
    from roomnet_tpu.train import loop as jloop

    assert [f.name for f in dataclasses.fields(TrainConfig)] == [f.name for f in dataclasses.fields(jloop.TrainConfig)]
    assert [f.name for f in dataclasses.fields(Phase)] == [f.name for f in dataclasses.fields(jloop.Phase)]
    for total in (400, 160_000):
        assert [dataclasses.asdict(p) for p in TrainConfig.reference_curriculum(total)] == [
            dataclasses.asdict(p) for p in jloop.TrainConfig.reference_curriculum(total)]
    for k in ("train_steps", "save_freq", "learn_rate", "l2_coeff", "val_batch_size", "stall_timeout_s", "seed"):
        assert getattr(TrainConfig(), k) == getattr(jloop.TrainConfig(), k)


# -- the train subcommand --------------------------------------------------------


def test_train_parser_has_the_jax_dests_plus_device():
    t = vars(tcli.build_parser().parse_args(["train"]))
    j = vars(jcli.build_parser().parse_args(["train"]))
    assert set(t) == set(j) | {"device"}
    for k in j:
        if k != "fn":
            assert t[k] == j[k], k
    assert t["device"] is None
    args = tcli.build_parser().parse_args(["train", "--ckpt-backend", "npz", "--feed-mode", "replicated",
                                           "--device", "cpu", "--curriculum", "--precision", "f32"])
    assert (args.ckpt_backend, args.feed_mode, args.device) == ("npz", "replicated", "cpu")


@pytest.mark.parametrize("argv,dest,value", [(["--data-parallel"], "data_parallel", True),
                                              (["--ckpt-backend", "orbax"], "ckpt_backend", "orbax"),
                                              (["--feed-mode", "sharded"], "feed_mode", "sharded")],
                         ids=["data-parallel", "orbax", "sharded"])
def test_train_parser_refuses_what_waits_for_scale_out(argv, dest, value, capsys):
    """The Scale-out flags parse to the JAX parser's values, and since the
    server's mesh so does serve --data-parallel; what still waits refuses as
    it parses: the bench subcommand."""
    assert getattr(tcli.build_parser().parse_args(["train", *argv]), dest) == value
    assert getattr(jcli.build_parser().parse_args(["train", *argv]), dest) == value
    for parser in (tcli.build_parser(), jcli.build_parser()):
        assert parser.parse_args(["serve", "--data-parallel"]).data_parallel is True
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["bench"])
    assert "invalid choice: 'bench'" in capsys.readouterr().err


def test_train_cli_runs_on_the_cpu(data_dir, monkeypatch, capsys):
    """`python -m roomnet_tpu_torch train` on the CPU from its working dir:
    --steps is the run's length and the decay horizon; checkpoints at the
    save points and a stats JSON of one entry each."""
    seen = {}
    real = tcli._model_cfg

    def model_cfg(side, bf16):
        seen["bf16"] = bf16
        assert real(224, bf16=bf16) is not None
        return CFG2

    monkeypatch.setattr(tcli, "_model_cfg", model_cfg)
    monkeypatch.chdir(data_dir)
    tcli.main(["train", "--data-dir", str(data_dir / "data"), "--steps", "7", "--save-freq", "3",
               "--model-dir", "m", "--img-side", "32", "--precision", "f32", "--device", "cpu"])
    assert seen == {"bf16": False}
    out = capsys.readouterr().out
    assert "Step 7 loss" in out and "learn_rate = " in out
    steps = [s for s, _, _ in CheckpointStore(str(data_dir / "m")).list_checkpoints()]
    assert steps == [3, 6]
    assert [e["step"] for e in json.load(open(data_dir / "all_train_stats.json"))] == [3, 6]
    assert (data_dir / "train_list.txt").exists() and (data_dir / "label_mappings.json").exists()
