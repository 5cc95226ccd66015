"""From-scratch training on the synthetic 6-class dataset through the full
reference curriculum, with the PyTorch port (roomnet_tpu_torch) on a CUDA
card: the port's counterpart of tools/train_synth.py, on the same data,
flags, constants and summary.

Four phases (batch 8 -> 32 -> 40 -> 45; batch statistics with the moving
update, dropout 0.3 in phases 2-3, then the BN freeze), a full validation
epoch and an accuracy-named checkpoint every --save-freq steps, stats in the
reference schema, resume-latest from --workdir/models. bf16 compute
(FAST_CONFIG). Writes --workdir/summary.json with the JAX tool's keys and the
accuracy and per-class plots (where matplotlib is installed).

    python tools/train_synth_torch.py --steps 16000 --workdir /tmp/synth_run_torch
    python tools/train_synth_torch.py --steps 8 --device cpu   # the plain versions

Imports neither jax nor roomnet_tpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_synth(data_dir: str, workdir: str, steps: int, *, per_class: int = 600, save_freq: int = 100,
                learn_rate: float = 2e-4, seed: int = 0, cfg=None, device=None) -> dict:
    """Generate the dataset into `data_dir` unless it is there, train
    `steps` steps (resuming the newest checkpoint in workdir/models) and
    write workdir/summary.json and the plots. `cfg` defaults to the port's
    FAST_CONFIG (224², bf16); `device` to the CUDA card. Returns the
    summary (only steps, wall_s and n_validations when no validation ran)."""
    from roomnet_tpu_torch.models.roomnet import FAST_CONFIG
    from roomnet_tpu_torch.train.loop import TrainConfig, Trainer, phase_at

    cfg = cfg or FAST_CONFIG
    if not os.path.isdir(os.path.join(data_dir, "Kitchen")):
        from tools.make_synth_dataset import generate

        print("generating synthetic dataset ...")
        generate(data_dir, per_class, seed)

    os.makedirs(workdir, exist_ok=True)
    tc = TrainConfig(
        data_dir=data_dir,
        train_list_fpath=os.path.join(workdir, "train_list.txt"),
        val_list_fpath=os.path.join(workdir, "val_list.txt"),
        stats_fpath=os.path.join(workdir, "all_train_stats.json"),
        model_dir=os.path.join(workdir, "models"),
        img_side=cfg.im_side,
        train_steps=100_000,  # the learning rate's decay horizon (reference train.py:31)
        save_freq=save_freq,
        learn_rate=learn_rate,
        l2_coeff=6e-2,
        val_batch_size=64,
        seed=seed,
        phases=TrainConfig.reference_curriculum(total_steps=steps),
        stall_timeout_s=900.0,
    )
    t0 = time.time()
    state = Trainer(tc, cfg, device=device).train(total_steps=steps, log_every=25)
    wall = time.time() - t0

    stats = []
    if os.path.isfile(tc.stats_fpath):
        with open(tc.stats_fpath) as f:
            stats = json.load(f)
    if not stats:  # steps < save_freq: no validation ran
        summary = {"steps": int(state.step), "wall_s": round(wall, 1), "n_validations": 0}
        print(json.dumps(summary))
        return summary
    best = max(stats, key=lambda s: s["accuracy"])
    images_seen = sum(phase_at(tc.phases, s).batch_size for s in range(steps))
    summary = {
        "steps": int(state.step),
        "wall_s": round(wall, 1),
        "img_per_s_train_incl_val": round(images_seen / wall, 1),
        "best_accuracy": best["accuracy"],
        "best_step": best["step"],
        "final_accuracies": [s["accuracy"] for s in stats[-5:]],
        "n_validations": len(stats),
        "phases": [dataclasses.asdict(p) for p in tc.phases],
    }
    with open(os.path.join(workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    plot(tc.stats_fpath, tc.val_list_fpath, workdir)
    return summary


def plot(stats_fpath: str, val_list_fpath: str, out_dir: str) -> None:
    """The accuracy and per-class plots through the port's plotter, the val
    list's size on their axes. Plotting never kills a finished run: a
    failure (a host without matplotlib) is printed."""
    try:
        from roomnet_tpu_torch.plotting.plotter import plot_training_stats

        with open(val_list_fpath) as f:
            n_val = sum(1 for line in f if line.strip())
        plot_training_stats(stats_fpath, out_dir=out_dir, val_size=n_val)
        print("plots written to", out_dir)
    except Exception as e:  # noqa: BLE001 — the run's results are already written
        print("plotting failed:", e)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--data-dir", default="/tmp/synth_rooms")
    ap.add_argument("--per-class", type=int, default=600)
    ap.add_argument("--workdir", default="/tmp/synth_run")
    ap.add_argument("--save-freq", type=int, default=100)
    ap.add_argument("--learn-rate", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card; 'cpu' runs the kernels' plain PyTorch "
                         "versions; with no GPU and no --device the tool raises)")
    args = ap.parse_args(argv)
    train_synth(args.data_dir, args.workdir, args.steps, per_class=args.per_class, save_freq=args.save_freq,
                learn_rate=args.learn_rate, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
