"""Offline reverse converter: the flat variables -> a TF1 checkpoint with the
reference graph's variable names (port of roomnet_tpu/params/export_tf.py).

A model trained here exports to a TensorBundle checkpoint that the
reference's own graph restores by name: pair the written `.data`/`.index`
with the reference's `roomnet.meta` (network.py:46-47, :122). It holds
exactly the 79 model tensors, as the frozen reference checkpoint does.
TensorFlow is imported only inside `export_tf_checkpoint` (offline tool).

    python -m roomnet_tpu_torch convert-to-tf --params artifacts/roomnet_params.npz \\
        --out exported_tf/roomnet
    python -m roomnet_tpu_torch.params.export_tf --params artifacts/roomnet_params.npz \\
        --out exported_tf/roomnet
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig
from . import schema


def export_tf_checkpoint(flat: dict[str, np.ndarray], out_prefix: str, cfg: RoomNetConfig = DEFAULT_CONFIG) -> str:
    """Write our flat variable dict as a TF1 TensorBundle checkpoint named by
    `schema.tf_name_map`; returns its path. Raises KeyError when a model
    tensor is missing."""
    import tensorflow.compat.v1 as tf  # offline tool only

    # A graph of its own, not `disable_eager_execution()`: that would switch
    # eager off for the rest of the process.
    name_map = schema.tf_name_map(cfg)
    missing = sorted(set(name_map) - set(flat))
    if missing:
        raise KeyError(f"flat variables missing for export: {missing}")
    graph = tf.Graph()
    with graph.as_default():
        tf_vars = [tf.get_variable(tf_name, initializer=tf.constant(np.asarray(flat[ours], np.float32)),
                                   dtype=tf.float32)
                   for ours, tf_name in sorted(name_map.items())]
        saver = tf.train.Saver(var_list=tf_vars)
        os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
        with tf.Session(graph=graph) as sess:
            sess.run(tf.global_variables_initializer())
            # No meta graph: the graph is the reference's own roomnet.meta.
            return saver.save(sess, out_prefix, write_meta_graph=False)


def export_params_file(params_path: str, out_prefix: str) -> tuple[str, int]:
    """A flat-params npz (or a checkpoint: its ``opt/`` and ``meta/`` keys
    are dropped) as a TF checkpoint. Returns (checkpoint path, tensors)."""
    with np.load(params_path) as data:
        flat = {k: v for k, v in data.items() if not k.startswith(("opt/", "meta/"))}
    return export_tf_checkpoint(flat, out_prefix), len(flat)


def main(argv=None):
    """`python -m roomnet_tpu_torch.params.export_tf`: the JAX module's flags
    and defaults (those of the CLI's `convert-to-tf`)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--params", default="artifacts/roomnet_params.npz")
    p.add_argument("--out", default="exported_tf/roomnet", help="TF checkpoint prefix to write")
    args = p.parse_args(argv)
    path, n = export_params_file(args.params, args.out)
    print(f"exported {n} tensors -> {path} (pair with the reference roomnet.meta)")


if __name__ == "__main__":
    main()
