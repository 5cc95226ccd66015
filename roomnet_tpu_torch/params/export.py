"""Model export to TFLite and to a TF SavedModel (port of
roomnet_tpu/params/export.py): the mobile and TF-Serving deployments.

The graph is built from plain TF ops (`_tf_forward`) out of the port's
variables. TensorFlow is an offline dependency, imported only inside the
functions that need it: export runs on a host with TensorFlow (the card's
host has none) and needs no GPU.
"""

from __future__ import annotations

import os

import numpy as np


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _tf_forward(variables, x, cfg):
    """The inference forward in plain TF ops (moving-stats BN, no dropout),
    softmax included, on a batch of any size, the unknown one too.

    Every op maps to a TFLite builtin: CONV_2D, RELU6, AVERAGE_POOL_2D,
    MUL/ADD (inference BN folded to one affine by `ops/blocks.bn_fold`),
    RESIZE_BILINEAR (the TF1 legacy op itself: align_corners=False,
    half_pixel_centers=False, the reference residual resize,
    network.py:199), RESHAPE, FULLY_CONNECTED, SOFTMAX."""
    import tensorflow as tf

    from ..ops.blocks import bn_fold

    def bn_affine(h, bn):
        a, b = bn_fold(bn, cfg.bn_eps)
        return h * tf.constant(_np(a)) + tf.constant(_np(b))

    for bi, blk in enumerate(variables["blocks"]):
        depth = len(blk["conv"])
        pool = cfg.block_pools[bi]
        res_in = None
        for d in range(depth):
            x = tf.nn.conv2d(x, tf.constant(_np(blk["conv"][d])), strides=1, padding="VALID")
            x = tf.nn.relu6(x)
            if pool is not None:
                x = tf.nn.avg_pool2d(x, pool[0], pool[1], "VALID")
            x = bn_affine(x, blk["bn"][d])
            if d == 0:
                res_in = x
        if depth > 1:
            x = x + tf.compat.v1.image.resize_bilinear(res_in, (x.shape[1], x.shape[2]), align_corners=False,
                                                       half_pixel_centers=False)
            x = bn_affine(x, blk["res_bn"])
    # -1 for the batch: a SavedModel's batch is unknown while it is traced.
    x = tf.reshape(x, (-1, int(np.prod(x.shape[1:]))))
    for layer in variables["dense"]:
        x = tf.linalg.matmul(x, tf.constant(_np(layer["kernel"])))
        if layer["bias"] is not None:
            x = x + tf.constant(_np(layer["bias"]))
        x = tf.nn.relu6(x)  # unconditional, the logits included (network.py:214)
        if layer["bn"] is not None:
            x = bn_affine(x, layer["bn"])
    return tf.nn.softmax(x, axis=-1)


def _representative_dataset(cfg, n: int = 96):
    """Calibration batches for full-int8 quantization: the procedural
    photo-like images of tools/make_synth_dataset.make_image, normalized as
    the model's input (RGB in [-1, 1])."""
    import sys

    tools = os.path.join(os.path.dirname(__file__), "..", "..", "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from make_synth_dataset import make_image

    rng = np.random.RandomState(20260819)

    def gen():
        for i in range(n):
            im = make_image(i % 6, rng, cfg.im_side, cfg.im_side)  # RGB uint8
            yield [((im.astype(np.float32) / 255.0) * 2.0 - 1.0)[None]]

    return gen


def export_tflite(variables, out_path: str, cfg=None, *, quantize: str | None = None) -> str:
    """Forward + softmax as a .tflite flatbuffer of TFLITE_BUILTINS only
    (the stock interpreter loads it, no Flex delegate; reference
    Classifier.java:189). Input: (1, im_side, im_side, 3) float32 RGB in
    [-1, 1] (network.py:28).

    quantize: None (float32), "dynamic" (int8 weights, float activations)
    or "int8" (full integer with a representative dataset, float32 I/O at
    the edges, so the float demo patch works unchanged)."""
    import tensorflow as tf

    from ..models.roomnet import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    if quantize not in (None, "dynamic", "int8"):
        raise ValueError(f"quantize must be None|'dynamic'|'int8', got {quantize!r}")
    tf_fn = tf.function(lambda x: _tf_forward(variables, x, cfg),
                        input_signature=[tf.TensorSpec((1, cfg.im_side, cfg.im_side, 3), tf.float32)],
                        autograph=False)
    converter = tf.lite.TFLiteConverter.from_concrete_functions([tf_fn.get_concrete_function()])
    converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS]
    if quantize is not None:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    if quantize == "int8":
        converter.representative_dataset = _representative_dataset(cfg)
        converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    blob = converter.convert()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path


def export_saved_model(variables, out_dir: str, cfg=None) -> str:
    """Forward + softmax + argmax as a TF SavedModel (TF-Serving), its
    function `f` returning {"class_id": int32 (B,), "probs": (B, classes)}
    from (B, im_side, im_side, 3) float32 RGB in [-1, 1], B unknown in the
    signature."""
    import tensorflow as tf

    from ..models.roomnet import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG

    def infer_fn(x):
        probs = _tf_forward(variables, x, cfg)
        return {"class_id": tf.argmax(probs, axis=-1, output_type=tf.int32), "probs": probs}

    module = tf.Module()
    module.f = tf.function(infer_fn, autograph=False,
                           input_signature=[tf.TensorSpec((None, cfg.im_side, cfg.im_side, 3), tf.float32)])
    tf.saved_model.save(module, out_dir)
    return out_dir
