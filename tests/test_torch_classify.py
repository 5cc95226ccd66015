"""The port's host decode and directory classification against roomnet_tpu.

The same image files go to the JAX package's classifier and to the port's
(`device="cpu"`, the kernels' plain versions), both at roomnet-tiny with
the same weights, unless a test says otherwise. Tolerances: decoded pixels
identical (the port's g++ build of roomnet_io.cpp and the JAX package's
committed library, and cv2 on both sides); ids, ok masks, `.xls`/`.csv`
names and labels and stats dicts equal; confidences within 1e-5 (f32
forwards in another order). The last test runs the full-width 224 model on
the 64 wide-golden images, written as PNG files by chip_smoke.py's writer:
argmax equal to the TF graph's, probs within 1e-5 of the port's `predict`.
"""

import csv
import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from torch.profiler import record_function

import chip_smoke
from roomnet_tpu.data import dataset as jdataset
from roomnet_tpu.data import loader as jloader
from roomnet_tpu.data import native as jnative
from roomnet_tpu.infer import classify as JC
from roomnet_tpu.models import registry as jreg
from roomnet_tpu.models import roomnet as JM
from roomnet_tpu.params import schema as jschema
from roomnet_tpu.train import metrics as jmetrics
from roomnet_tpu.utils import xls as jxls
from roomnet_tpu_torch.data import dataset as tdataset
from roomnet_tpu_torch.data import loader as tloader
from roomnet_tpu_torch.data import native as tnative
from roomnet_tpu_torch.infer import classify as TC
from roomnet_tpu_torch.models import registry as treg
from roomnet_tpu_torch.ops.kernels import _build
from roomnet_tpu_torch.ops.resize import resize_bilinear_half_pixel
from roomnet_tpu_torch.params import schema as tschema
from roomnet_tpu_torch.train import metrics as tmetrics
from roomnet_tpu_torch.utils import profiling as tprof
from roomnet_tpu_torch.utils import xls as txls
from tests.conftest import ARTIFACTS, GOLDEN_DIR

cv2 = pytest.importorskip("cv2")

CONF_TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """roomnet-tiny weights for both packages: JAX-initialised with random
    BN statistics, a seed under which write_images' files fall in several
    classes."""
    jcfg, tcfg = jreg.get("roomnet-tiny"), treg.get("roomnet-tiny")
    rng = np.random.RandomState(3)
    flat = jschema.flatten_variables(JM.init_variables(jax.random.PRNGKey(3), jcfg))
    for k in flat:
        if "bn/" in k:
            n, field = flat[k].shape, k.rsplit("/", 1)[1]
            flat[k] = {"scale": rng.rand(*n) + 0.5, "bias": rng.randn(*n) * 0.1,
                       "mean": rng.randn(*n) * 0.1, "var": rng.rand(*n) + 0.5}[field].astype(np.float32)
    return {"jcfg": jcfg, "tcfg": tcfg, "jv": jschema.unflatten_variables(flat, jcfg),
            "tv": tschema.variables_from_numpy(flat, tcfg, "cpu")}


def make_pair(weights, **kw):
    """(JAX classifier, port classifier) with the same options."""
    return (JC.RoomNetClassifier(weights["jv"], weights["jcfg"], **kw),
            TC.RoomNetClassifier(weights["tv"], weights["tcfg"], device="cpu", **kw))


@pytest.fixture(scope="module")
def pair(weights):
    return make_pair(weights, batch_size=4)


def write_images(d, n, side=48, seed=0, ext=None):
    """n smooth images of mixed shapes (tall, wide, square) as PNG and JPEG:
    a colour each, a sinusoid and a little noise."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        h, w = [(side + 3 * i, side), (side, side + 5 * i), (side, side)][i % 3]
        yy, xx = np.mgrid[0:h, 0:w] * (32.0 / side)
        wave = np.sin(xx * rng.rand() * 0.8 + yy * rng.rand() * 0.8)[..., None] * rng.randint(0, 128, 3)
        im = np.clip(rng.randint(0, 256, 3) + wave + rng.randn(h, w, 3) * 4, 0, 255).astype(np.uint8)
        p = os.path.join(d, f"photo {i}.{ext or ('png' if i % 2 == 0 else 'jpg')}")
        cv2.imwrite(p, im)
        paths.append(p)
    return paths


def write_corrupt(d, name="corrupt.jpg"):
    p = os.path.join(d, name)
    with open(p, "w") as f:
        f.write("not an image")
    return p


def assert_same_predictions(a, b):
    ids_a, confs_a, ok_a = a
    ids_b, confs_b, ok_b = b
    np.testing.assert_array_equal(ok_a, ok_b)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(confs_a, confs_b, rtol=0, atol=CONF_TOL)


# -- decode --------------------------------------------------------------------


def test_native_decoder_is_the_ports_own_build():
    """The port builds roomnet_io.cpp into build/roomnet_tpu_torch/ and
    never loads the JAX package's committed csrc/libroomnet_io.so."""
    assert tnative.available(), "g++ with the libjpeg/libpng headers is expected here"
    path = _build.host_library_path("roomnet_io")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert tnative._LIB._name == str(path)
    assert "csrc/libroomnet_io.so" not in tnative._LIB._name.replace(os.sep, "/")


@pytest.mark.parametrize("backend", ["native", "cv2", "native-fast"])
def test_load_pixels_match_jax(weights, tmp_path, backend):
    """`_load` (or `_load_cv2`) gives the JAX package's pixels exactly, on
    PNG and JPEG of every orientation; fast_decode on large JPEGs too."""
    if backend == "native-fast":
        jc, tc = make_pair(weights, fast_decode=True)
        paths = write_images(str(tmp_path), 4, side=200, ext="jpg")
    else:
        jc, tc = make_pair(weights)
        paths = write_images(str(tmp_path), 6)
        gray = os.path.join(str(tmp_path), "gray.png")
        cv2.imwrite(gray, np.random.RandomState(1).randint(0, 256, (40, 52), np.uint8))
        paths.append(gray)
    assert jnative.available() and tnative.available()
    for p in paths:
        if backend == "cv2":
            got, want = tc._load_cv2(p), jc._load_cv2(p)
        else:
            got, want = tc._load(p), jc._load(p)
        assert got.shape == (32, 32, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=p)


def test_native_within_one_level_of_half_pixel_resize(tmp_path):
    """The native crop+resize of a PNG against resize_bilinear_half_pixel on
    the same crop (float arithmetic both, rounded): at most one gray level."""
    rng = np.random.RandomState(2)
    for i, (h, w) in enumerate([(90, 70), (64, 120), (33, 33)]):
        im = rng.randint(0, 256, (h, w, 3), np.uint8)
        p = os.path.join(str(tmp_path), f"{i}.png")
        cv2.imwrite(p, im)
        crop = tloader.draw_crop_rect(h, w, random_crop=False, rng=None)
        got = tnative.load_preprocess(p, crop, 24)
        cx, cy, cw, ch = crop
        src = torch.from_numpy(np.ascontiguousarray(im[cy: cy + ch, cx: cx + cw])[None]).float()
        want = resize_bilinear_half_pixel(src, (24, 24)).round().clamp(0, 255)[0].numpy()
        assert np.abs(got.astype(np.float32) - want).max() <= 1


def test_load_preprocess_batch_writes_into_out(tmp_path):
    paths = write_images(str(tmp_path), 5) + [write_corrupt(str(tmp_path))]
    crops = np.full((6, 4), -1, np.int32)
    flips = np.zeros((6, 2), np.int32)
    want, ok = tnative.load_preprocess_batch(paths, crops, 16, flips)
    out = np.full((8, 16, 16, 3), 7, np.uint8)
    got, ok2 = tnative.load_preprocess_batch(paths, crops, 16, flips, out=out)
    assert got.base is out or got.base is out.base
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, [True] * 5 + [False])
    np.testing.assert_array_equal(ok2, ok)
    assert (out[5] == 0).all() and (out[6:] == 7).all()
    jwant, jok = jnative.load_preprocess_batch(paths, crops, 16, flips)
    np.testing.assert_array_equal(want, jwant)
    np.testing.assert_array_equal(ok, jok)
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.load_preprocess_batch(paths, crops, 16, flips, out=np.empty((4, 16, 16, 3), np.uint8))


@pytest.mark.parametrize("shape", [(40, 40), (40, 57), (57, 40), (1, 9), (9, 2)])
def test_crops_match_jax(shape):
    h, w = shape
    im = np.arange(h * w * 3, dtype=np.int64).reshape(h, w, 3)
    np.testing.assert_array_equal(tloader.center_crop(im), jloader.center_crop(im))
    assert (tloader.draw_crop_rect(h, w, random_crop=False, rng=None)
            == jloader.draw_crop_rect(h, w, random_crop=False, rng=None))
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    assert ([tloader.draw_crop_rect(h, w, random_crop=True, rng=a) for _ in range(5)]
            == [jloader.draw_crop_rect(h, w, random_crop=True, rng=b) for _ in range(5)])


def test_list_lines_and_stats_match_jax():
    for line in ["/a/b c/photo 1.jpg 3\n", "x.png 0", "  dir/with  two.png 5 \n"]:
        assert tdataset.parse_list_line(line) == jdataset.parse_list_line(line)
    rng = np.random.RandomState(4)
    y_t, y_p = rng.randint(0, 6, 50), rng.randint(0, 6, 50)
    for nc in (None, 6, 8):
        assert tmetrics.make_stats_entry(7, y_t, y_p, nc) == jmetrics.make_stats_entry(7, y_t, y_p, nc)


def test_xls_bytes_match_jax(tmp_path):
    books = []
    for mod, name in ((txls, "t.xls"), (jxls, "j.xls")):
        wb = mod.Workbook()
        sh = wb.add_sheet("classification_results")
        for r in range(30):
            sh.write(r, r % 3, f"cell {r} é")
        wb.save(str(tmp_path / name))
        books.append((tmp_path / name).read_bytes())
    assert books[0] == books[1]
    assert txls.read_labels_biff2(str(tmp_path / "t.xls")) == jxls.read_labels_biff2(str(tmp_path / "j.xls"))


def test_chip_smoke_png_writer_round_trips(tmp_path):
    """chip_smoke.py writes the card's test directory with its own PNG
    writer: cv2 must read back exactly the pixels it was given."""
    rng = np.random.RandomState(5)
    for i, shape in enumerate([(7, 11, 3), (30, 4, 3), (1, 1, 3)]):
        im = rng.randint(0, 256, shape, np.uint8)
        p = tmp_path / f"{i}.png"
        p.write_bytes(chip_smoke.png_bytes(im))
        np.testing.assert_array_equal(cv2.imread(str(p)), im)


# -- predict_paths -------------------------------------------------------------


def test_predict_paths_matches_jax(pair, tmp_path):
    """6 images at batch_size 4: one full and one ragged batch."""
    jc, tc = pair
    paths = write_images(str(tmp_path), 6)
    got = tc.predict_paths(paths)
    assert got[2].all() and len(set(got[0].tolist())) > 1
    assert_same_predictions(got, jc.predict_paths(paths))


@pytest.mark.parametrize("batch_size", [1, 64])
def test_predict_paths_batch_size_invariant(pair, weights, tmp_path, batch_size):
    jc, _ = pair
    _, tc = make_pair(weights, batch_size=batch_size)
    paths = write_images(str(tmp_path), 6) + [write_corrupt(str(tmp_path))]
    assert_same_predictions(tc.predict_paths(paths), jc.predict_paths(paths))


def test_unreadable_files_and_empty_list(pair, tmp_path):
    jc, tc = pair
    paths = write_images(str(tmp_path), 3)
    bad = write_corrupt(str(tmp_path))
    missing = os.path.join(str(tmp_path), "missing.png")
    mixed = [bad, paths[0], missing, paths[1], paths[2]]
    got = tc.predict_paths(mixed)
    assert_same_predictions(got, jc.predict_paths(mixed))
    np.testing.assert_array_equal(got[2], [False, True, False, True, True])
    assert (got[0][[0, 2]] == -1).all() and (got[1][[0, 2]] == 0).all()
    ids, confs, ok = tc.predict_paths([])
    assert ids.shape == (0,) and confs.shape == (0, 6) and ok.shape == (0,)
    ids, confs, ok = tc.predict_paths([bad, missing])
    assert (ids == -1).all() and not ok.any()


def test_bmp_takes_the_cv2_fallback(pair, tmp_path):
    """The native decoder reads JPEG and PNG only: a BMP is classified
    through the per-image cv2 retry, in the batch path and in `_load`."""
    jc, tc = pair
    bmp = os.path.join(str(tmp_path), "img.bmp")
    cv2.imwrite(bmp, np.random.RandomState(1).randint(0, 255, (40, 56, 3), np.uint8))
    assert tnative.probe(bmp) is None
    paths = write_images(str(tmp_path), 2) + [bmp]
    got = tc.predict_paths(paths)
    assert got[2].all()
    assert_same_predictions(got, jc.predict_paths(paths))
    np.testing.assert_array_equal(tc._load(bmp), jc._load(bmp))


def test_decode_stage_failure_raises_not_hangs(weights, tmp_path, monkeypatch):
    """A decode-stage exception (not a per-image decode failure, which is a
    None row) propagates out of predict_paths promptly: queued decode calls
    must not block on the depth semaphore while the executor's shutdown
    waits on them."""
    _, tc = make_pair(weights, batch_size=4)
    paths = write_images(str(tmp_path), 20)
    monkeypatch.setattr(tnative, "available", lambda: False)

    def exploding_load(fpath):
        raise RuntimeError("simulated decoder backend failure")

    monkeypatch.setattr(tc, "_load", exploding_load)
    out = {}

    def run():
        try:
            tc.predict_paths(paths)
            out["r"] = "returned"
        except RuntimeError as e:
            out["r"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t0 = time.monotonic()
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "predict_paths hung on decoder failure"
    assert out["r"] == "simulated decoder backend failure"
    assert time.monotonic() - t0 < 15


def test_no_decoder_raises_naming_both(weights, tmp_path, monkeypatch):
    """With neither the native build nor cv2, the first decode raises; it
    does not report every file unreadable."""
    _, tc = make_pair(weights, batch_size=4)
    paths = write_images(str(tmp_path), 3)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match=r"native decoder \(roomnet_io\) is unavailable.*cv2"):
        tc.predict_paths(paths)


def test_predict_stream_seam_matches_predict_paths(pair, tmp_path):
    """The decode seam fed the decoded arrays (None for the unreadable
    file) gives what predict_paths gives on the files."""
    _, tc = pair
    paths = write_images(str(tmp_path), 7) + [write_corrupt(str(tmp_path))]
    items = [tc._load(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        got = tc.predict_stream(len(items), TC.load_fill(items, lambda a: a, pool))
    want = tc.predict_paths(paths)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)


def test_predict_from_arrays_matches_predict_paths(pair, tmp_path):
    _, tc = pair
    paths = write_images(str(tmp_path), 9)
    x = np.stack([tc._load(p) for p in paths])
    ids, probs = tc.predict(x)
    want = tc.predict_paths(paths)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(probs, want[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="uint8"):
        tc.predict(x.astype(np.float32))


def test_close_stops_the_decode_thread(weights, tmp_path):
    """The decode thread outlives each call (a thread's first CUDA call is
    slow) and stops at close(); a single batch never needs it."""
    _, tc = make_pair(weights, batch_size=2)
    paths = write_images(str(tmp_path), 5)
    before = tc.predict_paths(paths)
    assert [t for t in threading.enumerate() if t.name.startswith("roomnet-decode")]
    tc.close()
    assert_same_predictions(tc.predict_paths(paths[:2]), tuple(a[:2] for a in before))
    with pytest.raises(RuntimeError, match="shutdown"):
        tc.predict_paths(paths)


# -- the staging layer's span and counter ----------------------------------------


def staging(call) -> dict:
    """The span registry's summary of `call()` alone."""
    tprof.SPANS.reset()
    call()
    return tprof.SPANS.summary()


@pytest.mark.parametrize("n", [10, 3], ids=["three-batches", "one-batch"])
def test_predict_records_the_fill_wait_and_bytes_once_per_batch(pair, n):
    """stage/wait_fill and stage/fill_bytes once per batch, whether the
    decode stage runs on the decode thread or (one batch) in the caller's;
    the bytes are N*S*S*3 exactly, and the wait on the fill is a part of
    e2e/wait_decode. A single batch is filled inside the caller's wait,
    so all of its fill is waited on."""
    _, tc = pair
    side = tc.host_side
    x = np.random.RandomState(0).randint(0, 256, (n, side, side, 3), np.uint8)
    got = staging(lambda: tc.predict(x))
    batches = -(-n // tc.batch_size)
    assert got["stage/wait_fill"]["count"] == got["e2e/wait_decode"]["count"] == batches
    assert got["stage/fill_bytes"] == {"total": n * side * side * 3, "count": batches}
    assert got["stage/wait_fill"]["total_s"] <= got["e2e/wait_decode"]["total_s"]
    assert batches > 1 or got["stage/wait_fill"]["total_s"] > 0


@pytest.mark.parametrize("slow", ["fill", "forward"])
def test_fill_wait_tells_the_hosts_fill_from_the_rest_of_the_wait(weights, monkeypatch, slow):
    """A fill that sleeps 20 ms a batch sets the pace: the main loop waits
    on it, and nearly all of e2e/wait_decode is stage/wait_fill. A forward
    that sleeps 20 ms a batch sets it: the decode stage runs ahead, and the
    wait on the fast fill is near 0, also where the decode thread is held
    by other work before the call (as a ring slot's last forward holds it
    on the card) and the main loop waits 100 ms for it."""
    tc = TC.RoomNetClassifier(weights["tv"], weights["tcfg"], device="cpu", batch_size=4)
    n_batches, pause = 6, 0.02
    classes = len(tc.class_labels)

    def forward(variables, x):
        if slow == "forward":
            time.sleep(pause)
        return torch.zeros(x.shape[0], dtype=torch.int64), torch.zeros(x.shape[0], classes)

    monkeypatch.setattr(tc, "_predict", forward)
    x = np.zeros((4 * n_batches, tc.host_side, tc.host_side, 3), np.uint8)

    def fill(start, stop, out):
        if slow == "fill":
            time.sleep(pause)
        out[: stop - start] = x[start:stop]
        return np.arange(stop - start)

    def call():
        held = tc._decoder.submit(time.sleep, 0.1 if slow == "forward" else 0.0)
        tc.predict_stream(len(x), fill)
        held.result()

    try:
        got = staging(call)
    finally:
        tc.close()
    waited, on_fill = got["e2e/wait_decode"]["total_s"], got["stage/wait_fill"]["total_s"]
    assert got["stage/wait_fill"]["count"] == n_batches
    if slow == "fill":
        assert waited >= 0.8 * n_batches * pause and on_fill >= 0.8 * waited
    else:
        assert waited >= 0.08 and on_fill < 0.1 * n_batches * pause


def test_predict_paths_counts_the_bytes_of_the_kept_rows_alone(pair, tmp_path):
    """An unreadable file fills no row of its batch: its bytes are not
    counted."""
    _, tc = pair
    paths = write_images(str(tmp_path), 8)
    paths.insert(3, write_corrupt(str(tmp_path)))
    side = tc.host_side
    got = staging(lambda: tc.predict_paths(paths))
    assert got["stage/fill_bytes"] == {"total": 8 * side * side * 3, "count": 3}


def test_all_thread_capture_puts_the_decode_thread_on_the_callers_clock(pair, tmp_path):
    """Under `trace_to(all_threads=True)`, the capture server's path, the
    chrome trace holds the decode thread's e2e/decode ranges, on another
    thread than the caller's and inside the caller's own range: both on
    the trace's one clock."""
    _, tc = pair
    x = np.zeros((12, tc.host_side, tc.host_side, 3), np.uint8)
    tc.predict(x)  # the decode thread exists before the capture
    with tprof.trace_to(str(tmp_path), all_threads=True):
        with record_function("caller_range"):
            tc.predict(x)
    events = [e for e in json.load(open(tmp_path / "trace.json"))["traceEvents"] if "dur" in e]
    outer = next(e for e in events if e["name"] == "caller_range")
    decodes = [e for e in events if e["name"] == "e2e/decode"]
    assert len(decodes) == 3
    for e in decodes:
        assert e["tid"] != outer["tid"]
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


# -- device_resize_side --------------------------------------------------------


@pytest.mark.parametrize("source_side", [96, 64], ids=["host-then-device", "device-only"])
def test_device_resize_side_matches_jax(weights, tmp_path, source_side):
    """The host ships 64² crops and the device resamples to 32²; with a
    64-side source the device resample is the only one."""
    jc, tc = make_pair(weights, batch_size=4, device_resize_side=64)
    assert tc.host_side == 64
    paths = write_images(str(tmp_path), 6, side=source_side)
    assert_same_predictions(tc.predict_paths(paths), jc.predict_paths(paths))


def test_device_resize_side_must_exceed_im_side(weights):
    for side in (32, 16):
        with pytest.raises(ValueError, match="must exceed"):
            TC.RoomNetClassifier(weights["tv"], weights["tcfg"], device="cpu", device_resize_side=side)


# -- classify_im_dir / groundtruth_validation -----------------------------------


def read_outputs(xl):
    """(xls rows {name: (label, conf)}, csv rows likewise, {label: files})."""
    cells = txls.read_labels_biff2(xl)
    assert cells[(0, 0)] == "IMAGE_NAME" and cells[(0, 1)] == "PREDICTED_LABEL"
    rows = {cells[(r, 0)]: (cells[(r, 1)], float(cells[(r, 2)])) for (r, c) in cells if r > 0 and c == 0}
    with open(xl[: -len("_results.xls")] + "_results.csv", newline="") as f:
        lines = list(csv.reader(f))
    assert lines[0] == ["IMAGE_NAME", "PREDICTED_LABEL", "CONFIDENCE"]
    csv_rows = {r[0]: (r[1], float(r[2])) for r in lines[1:]}
    out_dir = xl[: -len("_results.xls")]
    dirs = {lbl: sorted(os.listdir(os.path.join(out_dir, lbl))) for lbl in sorted(os.listdir(out_dir))}
    return rows, csv_rows, dirs


def assert_same_rows(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name][0] == b[name][0], name
        assert abs(a[name][1] - b[name][1]) <= CONF_TOL, name


@pytest.mark.parametrize("overlay", [False, True], ids=["copy", "overlay"])
def test_classify_im_dir_matches_jax(pair, tmp_path, overlay):
    """.xls and .csv rows, class folders and (overlay) the annotated copies
    equal the JAX package's; the corrupt file is skipped, and the
    extensionless file, which cv2.imwrite cannot encode, is copied raw with
    a warning."""
    jc, tc = pair
    d = str(tmp_path / "imgs")
    write_images(d, 7, side=64)
    write_corrupt(d)
    ok_enc, buf = cv2.imencode(".png", np.random.RandomState(7).randint(0, 255, (50, 48, 3), np.uint8))
    (tmp_path / "imgs" / "noext_photo").write_bytes(buf.tobytes())
    outs = {}
    for name, clf in (("jax", jc), ("port", tc)):
        out_dir = str(tmp_path / f"out_{name}")
        if overlay:
            with pytest.warns(UserWarning, match="overlay skipped"):
                xl = (JC if name == "jax" else TC).classify_im_dir(
                    clf, d, overlay=True, out_dir=out_dir, progress=False)
        else:
            xl = (JC if name == "jax" else TC).classify_im_dir(
                clf, d, overlay=False, out_dir=out_dir, progress=False)
        outs[name] = (out_dir, *read_outputs(xl))
    (jdir, jrows, jcsv, jdirs), (tdir, trows, tcsv, tdirs) = outs["jax"], outs["port"]
    assert len(trows) == 8 and "corrupt.jpg" not in trows
    assert_same_rows(trows, jrows)
    assert_same_rows(tcsv, jcsv)
    assert_same_rows(trows, tcsv)
    assert tdirs == jdirs
    for lbl, files in tdirs.items():
        for f in files:
            assert trows[f][0] == lbl
            a = open(os.path.join(tdir, lbl, f), "rb").read()
            b = open(os.path.join(jdir, lbl, f), "rb").read()
            src = open(os.path.join(d, f), "rb").read()
            if overlay and f != "noext_photo":
                assert a != src
                np.testing.assert_array_equal(cv2.imread(os.path.join(tdir, lbl, f)),
                                              cv2.imread(os.path.join(jdir, lbl, f)))
            else:
                assert a == b == src


def test_overlay_falls_back_to_copy_when_cv2_cannot_reread(pair, tmp_path, monkeypatch):
    """A file decoded for the prediction that cv2 cannot re-read for the
    overlay is copied unannotated with a warning; its row stays."""
    _, tc = pair
    d = str(tmp_path / "imgs")
    paths = write_images(d, 3)
    victim = paths[1]
    real_imread = cv2.imread
    armed = {"on": False}

    def flaky_imread(p, *a, **kw):
        if armed["on"] and os.path.abspath(p) == os.path.abspath(victim):
            return None
        return real_imread(p, *a, **kw)

    real_predict = tc.predict_paths

    def predict_then_arm(fpaths):
        out = real_predict(fpaths)
        armed["on"] = True
        return out

    monkeypatch.setattr(cv2, "imread", flaky_imread)
    monkeypatch.setattr(tc, "predict_paths", predict_then_arm)
    with pytest.warns(UserWarning, match="cv2 could not re-read it"):
        xl = TC.classify_im_dir(tc, d, overlay=True, progress=False)
    rows, _, dirs = read_outputs(xl)
    assert sorted(rows) == sorted(os.path.basename(p) for p in paths)
    out_dir = d + "_classified"
    lbl = rows[os.path.basename(victim)][0]
    copied = open(os.path.join(out_dir, lbl, os.path.basename(victim)), "rb").read()
    assert copied == open(victim, "rb").read()


def test_xls_row_cap_matches_jax(pair, tmp_path, monkeypatch):
    """Past 65,534 images the .xls stops (one warning) and the .csv carries
    every row, byte for byte as the JAX package writes them."""
    import shutil

    n = 0xFFFE + 2
    d = str(tmp_path / "imgs")
    one = write_images(d, 1)[0]
    monkeypatch.setattr(shutil, "copy", lambda *a, **k: None)
    written = {}
    for name, mod, clf in (("jax", JC, pair[0]), ("port", TC, pair[1])):
        monkeypatch.setattr(mod, "glob", lambda pattern: [one] * n)
        ids = np.arange(n) % 6
        confs = np.full((n, 6), 0.125, np.float32)
        monkeypatch.setattr(clf, "predict_paths", lambda fpaths: (ids, confs, np.ones(n, bool)))
        out_dir = str(tmp_path / f"out_{name}")
        with pytest.warns(UserWarning, match="65535-row limit") as rec:
            xl = mod.classify_im_dir(clf, d, overlay=False, out_dir=out_dir, progress=False)
        assert len([w for w in rec if "65535-row" in str(w.message)]) == 1
        written[name] = (open(xl, "rb").read(), open(out_dir + "_results.csv", "rb").read())
    assert written["port"] == written["jax"]
    rows, csv_rows, _ = read_outputs(str(tmp_path / "out_port_results.xls"))
    assert len(rows) == 1 and len(csv_rows) == 1  # one name, repeated
    with open(str(tmp_path / "out_port_results.csv")) as f:
        assert sum(1 for _ in f) == n + 1


def test_groundtruth_validation_matches_jax(pair, tmp_path):
    jc, tc = pair
    d = str(tmp_path / "imgs")
    paths = write_images(d, 8)
    bad = write_corrupt(d)
    ids, _, _ = tc.predict_paths(paths)
    lst = tmp_path / "list.txt"
    with open(lst, "w") as f:
        for k, (p, i) in enumerate(zip(paths, ids)):
            f.write(f"{p} {int(i) if k % 3 else (int(i) + 1) % 6}\n")
        f.write(f"{bad} 0\n\n")
    got = TC.groundtruth_validation(tc, str(lst))
    assert got == JC.groundtruth_validation(jc, str(lst))
    assert set(got) == {"accuracy", "precisions", "recalls", "f-scores"}
    assert got["accuracy"] == 5 / 8


# -- full width ----------------------------------------------------------------


def test_full_width_directory_matches_tf_golden(tmp_path):
    """The 64 wide-golden images in non-square canvases (plus 2x copies, a
    name with spaces, an extensionless copy and a corrupt file, as
    chip_smoke.py writes them) through classify_im_dir at 224, f32."""
    gw = dict(np.load(GOLDEN_DIR / "forward_golden_wide.npz"))
    variables = tschema.load_npz(ARTIFACTS / "roomnet_params.npz", device="cpu")
    clf = TC.RoomNetClassifier(variables, batch_size=16, device="cpu")
    d = str(tmp_path / "imgs")
    layout = chip_smoke.write_image_dir(d, gw["x_uint8_bgr"], seed=6)
    captured = {}
    real = clf.predict_paths

    def capture(fpaths):
        captured["paths"], captured["out"] = fpaths, real(fpaths)
        return captured["out"]

    clf.predict_paths = capture
    xl = TC.classify_im_dir(clf, d, overlay=False, progress=False)
    rows, csv_rows, _ = read_outputs(xl)
    names = [os.path.basename(p) for p in captured["paths"]]
    assert sorted(names) == sorted(layout["bytes"]) and len(names) == 75
    assert set(rows) == set(names) - {layout["corrupt"]} and rows == csv_rows
    ids, confs, ok = captured["out"]
    assert ok.sum() == 74 and not ok[names.index(layout["corrupt"])]
    want_ids, want_probs = clf.predict(gw["x_uint8_bgr"])
    np.testing.assert_array_equal(want_ids, gw["argmax"])
    for k, n in enumerate(names):
        if n in layout["golden"]:
            g = layout["golden"][n]
            assert ids[k] == gw["argmax"][g], n
            np.testing.assert_allclose(confs[k], want_probs[g], rtol=0, atol=1e-5)
            assert rows[n][0] == TC.CLASS_LABELS[gw["argmax"][g]]
