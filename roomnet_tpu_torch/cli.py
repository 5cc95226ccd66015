"""The port's CLI (port of roomnet_tpu/cli.py).

    python -m roomnet_tpu_torch train      --data-dir ./data/REI-Dataset [--curriculum]
    python -m roomnet_tpu_torch infer      --images-dir ./test_images [--no-overlay]
    python -m roomnet_tpu_torch validate   --list-file val_list.txt
    python -m roomnet_tpu_torch eval-ckpts --model-dir all_trained_models/... --list-file val_list.txt
    python -m roomnet_tpu_torch serve      [--model-dir ...] [--port 8000]
    python -m roomnet_tpu_torch convert    --tf-ckpt /path/to/final_model/roomnet
    python -m roomnet_tpu_torch convert-to-tf --params artifacts/roomnet_params.npz
    python -m roomnet_tpu_torch export     --out roomnet.tflite
    python -m roomnet_tpu_torch plot       [--stats all_train_stats.json]
    python -m roomnet_tpu_torch plot-checkpoints --model-dir all_trained_models/...
    python -m roomnet_tpu_torch label      --in-dir ./unlabeled
    python -m roomnet_tpu_torch doctor
    python -m roomnet_tpu_torch bench

Flags and defaults are the JAX package's, with these differences:
  * --device (default: the CUDA card) picks the device of the commands that
    run the model; `--device cpu` runs the kernels' plain PyTorch versions
    on the CPU. With no GPU and no --device those commands raise.
  * convert, convert-to-tf and export need TensorFlow, plot, plot-checkpoints
    and eval-ckpts --plot matplotlib: they run on a host that has them (the
    card's host has neither), and export builds its TF graph from weights
    on the CPU, with no GPU.
  * serve --profile-port serves on-demand torch.profiler captures
    (`GET /capture?seconds=S`, utils/profiling.start_server) in place of
    jax.profiler's gRPC server.
  * bench runs the port's own benchmark (roomnet_tpu_torch/bench.py), not
    the repo root's bench.py, which drives the JAX package.

--data-parallel runs the command on a mesh over every rank of the launch,
one process per card, rank 0 writing the outputs; for serve, rank 0 serves
HTTP and every rank computes its rows of each device call:

    torchrun --nproc-per-node N -m roomnet_tpu_torch serve --data-parallel ...

Without torchrun it is a world of one on this process's device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

DP_HELP = ("run on a mesh over every rank of the launch (torchrun --nproc-per-node N; a world of one "
           "without it), the batch split over the 'data' axis; rank 0 writes the outputs")
DEVICE_HELP = ("device to run on (default: the CUDA card; 'cpu' runs the kernels' plain "
               "PyTorch versions; with no GPU and no --device the command raises)")


def _load_variables(params_path: str, model_dir: str | None = None, device=None, cfg=None):
    """Variables of `cfg`'s architecture (default: roomnet-224's) from a
    flat npz, or resume-latest from a checkpoint dir (reference `nn.load()`,
    network.py:108-118), on `device`."""
    from .models.roomnet import DEFAULT_CONFIG
    from .params import schema

    cfg = cfg or DEFAULT_CONFIG
    if model_dir:
        from .params.checkpoint import open_store

        loaded = open_store(model_dir).load()
        if loaded is None:
            raise FileNotFoundError(f"no checkpoints in {model_dir}")
        var_flat, step = loaded
        print(f"loaded checkpoint at step {step} from {model_dir}")
        return schema.variables_from_numpy(var_flat, cfg, device)
    return schema.load_npz(params_path, cfg, device)


def _model_cfg(img_side: int, *, bf16: bool):
    """The config for the requested input geometry and precision, through
    the model registry (a non-224 model with the 224 config would fail on
    its dense head's shape)."""
    from .models import registry

    return registry.resolve(img_side, bf16=bf16)


def _device(args):
    from . import default_device

    return default_device(args.device)


def _maybe_mesh(args):
    """--data-parallel: a mesh over every rank of the launch (a world of one
    without torchrun), on --device or this rank's card. The batch must
    split evenly over the 'data' axis, checked before anything runs."""
    if not getattr(args, "data_parallel", False):
        return None
    from .parallel import distributed
    from .parallel.mesh import make_mesh

    distributed.initialize(device=args.device)
    mesh = make_mesh(devices=args.device)
    n_data = int(mesh.shape["data"])
    batch = getattr(args, "batch_size", None)
    if batch is not None and batch % n_data:
        raise SystemExit(f"--data-parallel: --batch-size {batch} is not divisible by the {n_data}-rank 'data' "
                         f"mesh — use a multiple of {n_data}")
    return mesh


def _is_rank0(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def cmd_train(args):
    from .train.loop import TrainConfig, Trainer

    kwargs = dict(
        data_dir=args.data_dir,
        train_steps=args.steps,
        save_freq=args.save_freq,
        keep_checkpoints=args.keep_checkpoints,
        learn_rate=args.learn_rate,
        l2_coeff=args.l2,
        model_dir=args.model_dir,
        img_side=args.img_side,
        seed=args.seed,
        restore_head=not args.fresh_head,
        ckpt_backend=args.ckpt_backend,
        steps_per_call=args.steps_per_call,
        stall_timeout_s=args.stall_timeout,
        stall_abort=args.stall_abort,
        feed_mode=args.feed_mode,
        val_use_batch_stats={"phase": None, "batch": True, "moving": False}[args.val_bn],
    )
    if args.curriculum:
        kwargs["phases"] = TrainConfig.reference_curriculum(args.steps)
    cfg = _model_cfg(args.img_side, bf16=args.precision == "bf16")
    mesh = _maybe_mesh(args)
    dev = mesh.device if mesh is not None else _device(args)
    Trainer(TrainConfig(**kwargs), cfg, device=dev, mesh=mesh).train()


def cmd_infer(args):
    from .infer.classify import RoomNetClassifier, classify_im_dir, dir_images

    mesh = _maybe_mesh(args)
    dev = mesh.device if mesh is not None else _device(args)
    cfg = _model_cfg(args.img_side, bf16=not args.exact)
    clf = RoomNetClassifier(
        _load_variables(args.params, args.model_dir, dev, cfg), cfg,
        batch_size=args.batch_size, fast_decode=args.fast_decode,
        device_resize_side=args.device_resize_side, device=dev, mesh=mesh,
    )
    if _is_rank0(mesh):
        xl = classify_im_dir(clf, args.images_dir, overlay=not args.no_overlay)
        print("Results:", xl)
    else:  # the same batches as rank 0's, for the collectives; rank 0 writes
        clf.predict_paths(dir_images(args.images_dir))


def cmd_validate(args):
    from .infer.classify import RoomNetClassifier, groundtruth_validation

    mesh = _maybe_mesh(args)
    dev = mesh.device if mesh is not None else _device(args)
    cfg = _model_cfg(args.img_side, bf16=not args.exact)
    clf = RoomNetClassifier(_load_variables(args.params, args.model_dir, dev, cfg), cfg,
                            batch_size=args.batch_size, device=dev, mesh=mesh)
    stats = groundtruth_validation(clf, args.list_file)
    if _is_rank0(mesh):
        print(json.dumps(stats, indent=2))


def cmd_eval_ckpts(args):
    from .infer.classify import evaluate_checkpoints

    mesh = _maybe_mesh(args)
    out = evaluate_checkpoints(
        args.model_dir, args.list_file, _model_cfg(args.img_side, bf16=not args.exact),
        batch_size=args.batch_size, backend=args.ckpt_backend,
        device=mesh.device if mesh is not None else _device(args), mesh=mesh,
    )
    if not _is_rank0(mesh):
        return
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if args.plot:
        from .plotting.plotter import plot_eval_sweep

        print("plot:", plot_eval_sweep(out, args.plot))
    for e in out["checkpoints"]:
        name_acc = "-" if e["name_accuracy"] is None else f"{e['name_accuracy']:.4f}"
        print(f"step {e['step']:>8}  name-acc {name_acc:>6}  "
              f"measured {e['accuracy']:.4f}  {e['checkpoint']}")
    b = out["best"]
    print(f"best: step {b['step']}  accuracy {b['accuracy']:.4f}  ({b['checkpoint']})")


def cmd_serve(args):
    from .infer.classify import RoomNetClassifier
    from .infer.server import ClassifierServer

    mesh = _maybe_mesh(args)
    dev = mesh.device if mesh is not None else _device(args)
    cfg = _model_cfg(args.img_side, bf16=not args.exact)
    clf = RoomNetClassifier(_load_variables(args.params, args.model_dir, dev, cfg), cfg,
                            batch_size=args.batch_size, device=dev, mesh=mesh)
    if _is_rank0(mesh):
        if args.profile_port:
            from .utils.profiling import start_server

            start_server(args.profile_port)
            print(f"torch.profiler capture server on :{args.profile_port} (GET /capture?seconds=S)")
        print(f"serving on http://{args.host}:{args.port}  (POST /classify, /classify_batch)")
    # Every rank of a mesh builds the same server; rank 0 serves, the others follow.
    return ClassifierServer(clf, host=args.host, port=args.port,
                     warmup=not args.no_warmup,
                     max_inflight=args.max_inflight,
                     request_timeout_s=args.request_timeout,
                     # The dir the weights came from: POST /reload swaps
                     # to its newest checkpoint.
                     model_dir=args.model_dir,
                     auto_reload_s=args.auto_reload,
                     access_log=args.access_log,
                     drain_s=args.drain).serve_forever()


def cmd_convert(args):
    from .params.convert_tf import convert_file

    print(f"converted {convert_file(args.tf_ckpt, args.out)} tensors -> {args.out}")


def cmd_convert_to_tf(args):
    from .params.export_tf import export_params_file

    path, n = export_params_file(args.params, args.out)
    print(f"exported {n} tensors -> {path} (pair with the reference roomnet.meta)")


def cmd_export(args):
    if args.format == "saved-model" and args.quantize:
        raise SystemExit("--quantize applies to TFLite only")
    # A SavedModel is a directory: its default is not the .tflite path.
    out_path = args.out or ("artifacts/roomnet_saved_model" if args.format == "saved-model"
                            else "artifacts/roomnet.tflite")
    # Both formats are float32 artifacts of a TF graph: the f32 config, and
    # the weights on the CPU (export needs no GPU).
    cfg = _model_cfg(args.img_side, bf16=False)
    variables = _load_variables(args.params, args.model_dir, "cpu", cfg)
    if args.format == "saved-model":
        from .params.export import export_saved_model

        out = export_saved_model(variables, out_path, cfg=cfg)
    else:
        from .params.export import export_tflite

        out = export_tflite(variables, out_path, cfg=cfg, quantize=args.quantize)
    print("exported:", out)


def cmd_plot(args):
    from .plotting.plotter import plot_training_stats

    print("\n".join(plot_training_stats(args.stats, args.out_dir)))


def cmd_plot_checkpoints(args):
    from .plotting.plotter import plot_checkpoint_accuracies

    print(plot_checkpoint_accuracies(args.model_dir))


def cmd_label(args):
    from .data.labeler import ImageLabeler

    ImageLabeler(args.in_dir).run_labeller(resume=not args.no_resume)


def cmd_doctor(args):
    """Environment diagnostics: one PASS/WARN/FAIL line per dependency the
    port's surfaces need. Exit code 1 on any FAIL."""
    checks = []  # (status, name, detail)

    def check(name, fn, *, warn_only=False):
        try:
            checks.append(("PASS", name, fn() or ""))
        except Exception as e:  # noqa: BLE001 — each check reports, never raises
            checks.append(("WARN" if warn_only else "FAIL", name, f"{type(e).__name__}: {e}"))

    def _torch():
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"torch {torch.__version__}: no CUDA device")
        return (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.device_count()}x {torch.cuda.get_device_name(0)}")

    check("torch + CUDA device", _torch)

    def _nvcc():
        from .ops.kernels import _build

        return _build._nvcc()

    check("nvcc (builds the kernels at first use)", _nvcc)

    def _kernels():
        from .ops.kernels import _build

        _build.build()
        for name in _build.SOURCES:
            _build.load(name)
        return f"{len(_build.SOURCES)} kernels built into {_build.BUILD_DIR}"

    check("CUDA kernels (conv3x3, relu6_pool_bn, residual_bn, dense_head)", _kernels)

    def _native():
        from .data import native

        if not native.available():
            raise RuntimeError("csrc/roomnet_io.cpp not built (g++ with libjpeg/libpng headers); "
                               "decode falls back to cv2")
        return "native decoder loaded"

    check("native decoder", _native, warn_only=True)

    def _cv2():
        import cv2

        return f"opencv {cv2.__version__}"

    check("cv2 (decode fallback, overlays, serving decode)", _cv2)

    def _params():
        import numpy as np

        from .models.roomnet import param_count
        from .params import schema

        path = args.params
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} missing — convert it with `python -m roomnet_tpu convert`")
        with np.load(path) as data:
            n = param_count(schema.variables_from_numpy(dict(data), device="cpu"))
        if n != 178062:
            raise ValueError(f"param count {n} != 178062")
        return f"{path}: 178,062 params"

    check("converted reference params", _params, warn_only=True)

    def _golden():
        base = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "golden")
        need = ["forward_golden.npz", "forward_golden_wide.npz", "grad_golden.npz", "traj_golden.npz"]
        missing = [f for f in need if not os.path.exists(os.path.join(base, f))]
        if missing:
            raise FileNotFoundError(", ".join(missing))
        return f"{len(need)} fixtures present"

    check("golden parity fixtures", _golden, warn_only=True)

    def _tf():
        import tensorflow as tf

        return f"tensorflow {tf.__version__} (convert/export available)"

    check("tensorflow (offline convert/export only)", _tf, warn_only=True)

    def _matplotlib():
        import matplotlib

        return f"matplotlib {matplotlib.__version__} (plot, plot-checkpoints, eval-ckpts --plot available)"

    check("matplotlib (offline plots only)", _matplotlib, warn_only=True)

    width = max(len(n) for _, n, _ in checks)
    failed = False
    for status, name, detail in checks:
        print(f"[{status}] {name:<{width}}  {detail}")
        failed |= status == "FAIL"
    sys.exit(1 if failed else 0)


def cmd_bench(args):
    from . import bench

    bench.main(args.device)


def _add_device(p):
    p.add_argument("--device", default=None, help=DEVICE_HELP)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="roomnet_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train / fine-tune (reference train.py)")
    t.add_argument("--data-dir", default="./data/REI-Dataset")
    t.add_argument("--steps", type=int, default=100_000,
                   help="steps of the run, and the horizon of the learning-rate decay")
    t.add_argument("--save-freq", type=int, default=10)
    t.add_argument("--keep-checkpoints", type=int, default=None, metavar="N",
                   help="opt-in retention: keep only the newest N regular checkpoints (+ the "
                        "best-accuracy one + all interrupt/stall markers); default keep-all, the "
                        "reference contract")
    t.add_argument("--learn-rate", type=float, default=2e-4)
    t.add_argument("--l2", type=float, default=6e-2)
    t.add_argument("--model-dir", default="all_trained_models/trained_models")
    t.add_argument("--img-side", type=int, default=224)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per call of the step function")
    t.add_argument("--fresh-head", action="store_true",
                   help="exclude the dense head on restore (network.py:78)")
    t.add_argument("--curriculum", action="store_true",
                   help="README.md:34-38 batch/dropout/BN-freeze schedule")
    t.add_argument("--feed-mode", choices=["replicated", "sharded"], default="replicated",
                   help="multi-rank input mode: sharded = each rank decodes only its rows of the batch")
    t.add_argument("--data-parallel", action="store_true", help=DP_HELP)
    t.add_argument("--ckpt-backend", choices=["npz", "orbax"], default="npz",
                   help="checkpoint store: portable npz, or orbax = DCP directories, asynchronous and saved "
                        "collectively (not the JAX package's orbax format)")
    t.add_argument("--stall-timeout", type=float, default=600.0,
                   help="watchdog: warn + emergency-checkpoint when no step completes for this many "
                        "seconds (0 disables)")
    t.add_argument("--stall-abort", action="store_true",
                   help="watchdog escalation: interrupt training after the emergency checkpoint")
    t.add_argument("--val-bn", choices=["phase", "batch", "moving"], default="phase",
                   help="validation BN statistics: 'phase' follows the active phase's "
                        "compute_bn_mean_var (reference nn.infer semantics), or force batch/moving stats")
    t.add_argument("--precision", choices=["bf16", "f32"], default="bf16",
                   help="bf16 = fast mixed-precision (default; f32 params, bf16 compute); f32 = "
                        "full-precision parity mode")
    _add_device(t)
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("infer", help="classify a directory (reference infer.py)")
    i.add_argument("--images-dir", required=True)
    i.add_argument("--params", default="artifacts/roomnet_params.npz")
    i.add_argument("--model-dir", default=None,
                   help="resume-latest from a training checkpoint dir instead of --params")
    i.add_argument("--batch-size", type=int, default=64)
    i.add_argument("--no-overlay", action="store_true")
    i.add_argument("--exact", action="store_true", help="f32 parity mode instead of bf16 serving mode")
    i.add_argument("--img-side", type=int, default=224,
                   help="model input geometry; must match the loaded weights' dense head "
                        "(README.md:32 variants)")
    i.add_argument("--device-resize-side", type=int, default=None,
                   help="ship center-cropped uint8 at this side and run the final resample on the "
                        "device")
    i.add_argument("--fast-decode", action="store_true",
                   help="DCT-scaled JPEG decode in the native decoder (>=2x supersampling enforced)")
    i.add_argument("--data-parallel", action="store_true", help=DP_HELP)
    _add_device(i)
    i.set_defaults(fn=cmd_infer)

    v = sub.add_parser("validate", help="score a labeled list file")
    v.add_argument("--list-file", required=True)
    v.add_argument("--params", default="artifacts/roomnet_params.npz")
    v.add_argument("--model-dir", default=None,
                   help="resume-latest from a training checkpoint dir instead of --params")
    v.add_argument("--batch-size", type=int, default=64)
    v.add_argument("--exact", action="store_true")
    v.add_argument("--img-side", type=int, default=224,
                   help="model input geometry; must match the loaded weights' dense head "
                        "(README.md:32 variants)")
    v.add_argument("--data-parallel", action="store_true", help=DP_HELP)
    _add_device(v)
    v.set_defaults(fn=cmd_validate)

    ev = sub.add_parser(
        "eval-ckpts",
        help="re-score every checkpoint in a dir against one list file (consistent model "
             "selection vs the filename accuracies legacy_plotter.py trusts)")
    ev.add_argument("--model-dir", required=True)
    ev.add_argument("--list-file", required=True)
    ev.add_argument("--batch-size", type=int, default=64)
    ev.add_argument("--exact", action="store_true")
    ev.add_argument("--img-side", type=int, default=224)
    ev.add_argument("--out", default=None, help="also write the full per-checkpoint JSON here")
    ev.add_argument("--ckpt-backend", choices=["auto", "npz", "orbax"], default="auto",
                    help="checkpoint store format in --model-dir (auto: npz files win if present; orbax = "
                         "the port's DCP directories)")
    ev.add_argument("--plot", default=None, metavar="PNG",
                    help="also render measured-vs-filename accuracy by step (needs matplotlib)")
    ev.add_argument("--data-parallel", action="store_true", help=DP_HELP)
    _add_device(ev)
    ev.set_defaults(fn=cmd_eval_ckpts)

    c = sub.add_parser("convert", help="TF checkpoint -> native params (needs TensorFlow)")
    c.add_argument("--tf-ckpt", default="/root/reference/final_model/roomnet")
    c.add_argument("--out", default="artifacts/roomnet_params.npz")
    c.set_defaults(fn=cmd_convert)

    c2 = sub.add_parser("convert-to-tf",
                        help="native params -> TF1 checkpoint the reference graph restores by name (needs "
                             "TensorFlow)")
    c2.add_argument("--params", default="artifacts/roomnet_params.npz")
    c2.add_argument("--out", default="exported_tf/roomnet", help="TF checkpoint prefix to write")
    c2.set_defaults(fn=cmd_convert_to_tf)

    pl = sub.add_parser("plot", help="stats JSON -> 4 PNGs (reference plotter.py; needs matplotlib)")
    pl.add_argument("--stats", default="all_train_stats.json")
    pl.add_argument("--out-dir", default="performance_plots")
    pl.set_defaults(fn=cmd_plot)

    lp = sub.add_parser("plot-checkpoints", help="accuracy from ckpt names (legacy_plotter.py; needs matplotlib)")
    lp.add_argument("--model-dir", required=True)
    lp.set_defaults(fn=cmd_plot_checkpoints)

    lb = sub.add_parser("label", help="manual labeling tool (manual_classifier.py)")
    lb.add_argument("--in-dir", required=True)
    lb.add_argument("--no-resume", action="store_true")
    lb.set_defaults(fn=cmd_label)

    e = sub.add_parser("export",
                       help="export to TFLite (pure builtins, stock-interpreter loadable) or a TF SavedModel "
                            "(TF-Serving containers); needs TensorFlow, no GPU")
    e.add_argument("--params", default="artifacts/roomnet_params.npz")
    e.add_argument("--model-dir", default=None, help="resume-latest from a training checkpoint dir")
    e.add_argument("--out", default=None,
                   help="output path (default: artifacts/roomnet.tflite, or artifacts/roomnet_saved_model "
                        "for saved-model)")
    e.add_argument("--format", choices=["tflite", "saved-model"], default="tflite",
                   help="saved-model: SavedModel dir with an unknown batch (forward+softmax+argmax) for "
                        "TF-Serving")
    e.add_argument("--quantize", choices=["dynamic", "int8"], default=None,
                   help="quantized variant (mobile/README.md for measured flip rates; dynamic is the "
                        "shipped one)")
    e.add_argument("--img-side", type=int, default=224,
                   help="model input geometry; must match the loaded weights' dense head")
    e.set_defaults(fn=cmd_export)

    s = sub.add_parser("serve", help="HTTP classification daemon")
    s.add_argument("--params", default="artifacts/roomnet_params.npz")
    s.add_argument("--model-dir", default=None,
                   help="resume-latest from a training checkpoint dir instead of --params")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--exact", action="store_true")
    s.add_argument("--img-side", type=int, default=224,
                   help="model input geometry; must match the loaded weights' dense head "
                        "(README.md:32 variants)")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip the warmup before the socket binds, which runs every bucket once and "
                        "builds the CUDA kernels (nvcc, ~15 s on a fresh checkout); without it the "
                        "first request pays the build against its --request-timeout budget")
    s.add_argument("--max-inflight", type=int, default=None,
                   help="admission cap before 429 shedding (default 4x max_batch)")
    s.add_argument("--access-log", default=None, metavar="PATH",
                   help="append one JSON line per answered request (method, path, status, ms)")
    s.add_argument("--auto-reload", type=float, default=None, metavar="S",
                   help="poll --model-dir every S seconds and hot-swap when a newer checkpoint "
                        "lands")
    s.add_argument("--profile-port", type=int, default=None,
                   help="serve on-demand torch.profiler captures of the live daemon on this port "
                        "(GET /capture?seconds=S answers the chrome trace's path)")
    s.add_argument("--drain", type=float, default=0.0, metavar="S",
                   help="graceful-drain window on SIGTERM/Ctrl-C: /readyz goes 503, new classify "
                        "work is shed with 503, and admitted requests get up to S seconds to "
                        "finish before shutdown (0: immediate, queued jobs fail fast)")
    s.add_argument("--request-timeout", type=float, default=30.0,
                   help="per-request budget cap (s), stamped at admission; clients may lower it "
                        "per request with the X-Timeout-Seconds header")
    s.add_argument("--data-parallel", action="store_true",
                   help=DP_HELP + "; rank 0 serves HTTP, the other ranks follow its device calls")
    _add_device(s)
    s.set_defaults(fn=cmd_serve)

    d = sub.add_parser("doctor", help="environment diagnostics (PASS/WARN/FAIL)")
    d.add_argument("--params", default="artifacts/roomnet_params.npz")
    d.set_defaults(fn=cmd_doctor)

    b = sub.add_parser("bench", help="run the benchmark (roomnet_tpu_torch/bench.py): one JSON line")
    _add_device(b)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    finally:
        if getattr(args, "data_parallel", False):
            from .parallel import distributed

            distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
