"""The port's data pipeline (roomnet_tpu_torch/data/dataset.py, loader.py)
against roomnet_tpu's.

Every behaviour of tests/test_loader.py, run on the port; then the parity
gates: `extract_fpaths` writes the JAX package's list files and label
mapping for the same seed, and `TrainFeeder` gives the JAX feeder's batches
byte for byte (x, y, batch_fpaths and train_state over two epochs, in train
and in val mode, through the native decoder and through cv2). Device
staging on the CPU: `to_device_async` / `on_stream` / `device_prefetch`
hand the arrays' values through (the card's copy-stream path is in
tests/test_torch_cuda.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from roomnet_tpu.data import dataset as jds
from roomnet_tpu.data import loader as jld
from roomnet_tpu.data import native as jnative
from roomnet_tpu_torch.data import native
from roomnet_tpu_torch.data.dataset import extract_fpaths, parse_list_line
from roomnet_tpu_torch.data.loader import (TrainFeeder, center_crop, device_prefetch, load_and_preprocess,
                                           on_stream, random_sliding_square_crop, to_device_async)

cv2 = pytest.importorskip("cv2")


def _write_imgs(root, cls, n, hw=(40, 60)):
    d = root / cls
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = str(d / f"im {i}.png")  # space in name: list format must survive
        cv2.imwrite(p, np.full((*hw, 3), i * 10 % 255, np.uint8))
        paths.append(p)
    return paths


# -- the behaviours of tests/test_loader.py ------------------------------------


def test_center_crop_geometry():
    """Same offset math as reference generator.py:69-78."""
    im = np.arange(5 * 9 * 3).reshape(5, 9, 3).astype(np.uint8)
    c = center_crop(im)
    assert c.shape == (5, 5, 3)
    np.testing.assert_array_equal(c, im[:, 2:7])
    im2 = np.arange(9 * 5 * 3).reshape(9, 5, 3).astype(np.uint8)
    assert center_crop(im2).shape == (5, 5, 3)
    sq = np.zeros((4, 4, 3), np.uint8)
    np.testing.assert_array_equal(center_crop(sq), sq)


def test_random_sliding_crop_is_square_and_in_bounds():
    rng = np.random.RandomState(0)
    im = np.arange(7 * 12 * 3).reshape(7, 12, 3).astype(np.uint8)
    for _ in range(20):
        assert random_sliding_square_crop(im, rng).shape == (7, 7, 3)
    im_t = im.transpose(1, 0, 2)
    for _ in range(20):
        assert random_sliding_square_crop(im_t, rng).shape == (7, 7, 3)
    # the JAX crop's draws, one for one
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(10):
        np.testing.assert_array_equal(random_sliding_square_crop(im, a), jld.random_sliding_square_crop(im, b))


def test_extract_fpaths_balanced_split(tmp_path):
    """Per-class train size = 90% of smallest class (reference train.py:84-88);
    unreadable images dropped up front (train.py:44-51)."""
    data = tmp_path / "data"
    _write_imgs(data, "Kitchen", 10)
    _write_imgs(data, "Bedroom", 20)
    (data / "Kitchen" / "broken.jpg").write_text("nope")
    train_txt, val_txt = extract_fpaths(str(data), str(tmp_path / "train.txt"), str(tmp_path / "val.txt"),
                                        str(tmp_path / "labels.json"), seed=0)
    assert len(train_txt) == 18  # smallest class = 10 readable -> 9/class
    pairs = [parse_list_line(l) for l in train_txt]
    assert all(os.path.exists(p) for p, _ in pairs)
    labels = [c for _, c in pairs]
    assert labels.count(0) == 9 and labels.count(1) == 9
    assert not any("broken" in p for p, _ in pairs)
    # warm path: second call reuses files verbatim
    train2, _ = extract_fpaths(str(data), str(tmp_path / "train.txt"), str(tmp_path / "val.txt"),
                               str(tmp_path / "labels.json"), seed=123)
    assert train2 == train_txt


def test_feeder_epoch_accounting_and_shapes(tmp_path):
    paths = _write_imgs(tmp_path / "d", "c0", 7)
    lines = [f"{p} 0\n" for p in paths]
    with TrainFeeder(lines, batch_size=3, im_side=16, shuffle=False, random_crop=False, preprocess=False,
                     seed=1) as f:
        assert f.batches_per_epoch == 2  # 7 // 3, tail dropped
        x, y = f.dequeue()
        assert x.shape == (3, 16, 16, 3) and x.dtype == np.uint8
        assert y.shape == (3,)
        assert f.train_state["epoch"] == 1 and f.train_state["batch"] == 1
        assert not f.train_state["previous_epoch_done"]
        f.dequeue()
        f.dequeue()  # first batch of epoch 2 flags the previous epoch done
        assert f.train_state["previous_epoch_done"]
        assert f.train_state["epoch"] == 2


def test_feeder_deterministic_given_seed(tmp_path):
    paths = _write_imgs(tmp_path / "d", "c0", 6, hw=(50, 30))
    lines = [f"{p} 0\n" for p in paths]

    def first_two(seed):
        with TrainFeeder(lines, batch_size=3, im_side=16, shuffle=True, random_crop=True, preprocess=True,
                         seed=seed) as f:
            return f.dequeue(), f.dequeue()

    (a1, _), (b1, _) = first_two(7)
    (a2, _), (b2, _) = first_two(7)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    (a3, _), _ = first_two(8)
    assert not np.array_equal(a1, a3)


def test_feeder_rows_slice_matches_full_batch(tmp_path):
    """rows=(lo, hi): the slice is row-identical to rows lo..hi of the full
    batch (per-row draws keyed to the GLOBAL row index)."""
    paths = _write_imgs(tmp_path / "d", "c0", 12, hw=(50, 30))
    lines = [f"{p} {i % 3}\n" for i, p in enumerate(paths)]

    def batches(rows, n=3):
        with TrainFeeder(lines, batch_size=6, im_side=16, shuffle=True, random_crop=True, preprocess=True,
                         seed=5, rows=rows) as f:
            return [f.dequeue() for _ in range(n)]

    full = batches(None)
    for (xf, yf), (xa, ya), (xb, yb) in zip(full, batches((0, 3)), batches((3, 6))):
        np.testing.assert_array_equal(xf[:3], xa)
        np.testing.assert_array_equal(yf[:3], ya)
        np.testing.assert_array_equal(xf[3:], xb)
        np.testing.assert_array_equal(yf[3:], yb)


def test_feeder_rows_validation():
    with pytest.raises(ValueError, match="out of range"):
        TrainFeeder(["x 0\n", "y 1\n"], batch_size=2, rows=(0, 3), start=False)


def test_feeder_skips_unreadable(tmp_path):
    paths = _write_imgs(tmp_path / "d", "c0", 4)
    bad = tmp_path / "d" / "c0" / "bad.jpg"
    bad.write_text("x")
    lines = [f"{p} 0\n" for p in paths[:2]] + [f"{bad} 0\n", f"{paths[2]} 0\n"]
    with TrainFeeder(lines, batch_size=4, im_side=8, shuffle=False, random_crop=False, preprocess=False) as f:
        x, y = f.dequeue()
        assert x.shape[0] == 3  # bad image dropped, batch shrinks


def test_feeder_flags_fully_unreadable_batch(tmp_path):
    """Whole batch unreadable: a zero batch of the full shape, flagged
    synthetic so consumers skip it."""
    d = tmp_path / "d"
    d.mkdir()
    bads = []
    for i in range(4):
        p = d / f"bad{i}.jpg"
        p.write_text("not an image")
        bads.append(str(p))
    lines = [f"{p} 0\n" for p in bads]
    with TrainFeeder(lines, batch_size=4, im_side=8, shuffle=False, random_crop=False, preprocess=False) as f:
        x, y = f.dequeue()
        assert x.shape == (4, 8, 8, 3) and not x.any()
        assert f.last_batch_synthetic and f.train_state["synthetic"]
    good = _write_imgs(tmp_path / "g", "c0", 1)
    with TrainFeeder([f"{good[0]} 0\n"] + lines[:3], batch_size=4, im_side=8, shuffle=False,
                     random_crop=False, preprocess=False) as f:
        x, y = f.dequeue()
        assert x.shape[0] == 1 and not f.last_batch_synthetic


def test_feeder_rejects_empty_list():
    with pytest.raises(ValueError, match="no usable paths"):
        TrainFeeder(["", "\n"], batch_size=4, im_side=8, start=False)


def test_parse_list_line_with_spaces():
    p, c = parse_list_line("C:\\data\\Living Room\\img 1.jpg 5\n")
    assert p == "C:\\data\\Living Room\\img 1.jpg" and c == 5


def _need_native():
    if not native.available():
        pytest.skip("the port's native decoder did not build here (g++ with libjpeg/libpng headers)")


def test_native_and_cv2_backends_agree(tmp_path):
    """Same seed -> same crop/flip draws -> pixels within one level from the
    native decoder and from cv2."""
    _need_native()
    p = _write_imgs(tmp_path / "d", "c0", 1, hw=(70, 50))[0]
    for kwargs in [dict(random_crop=False, augment=False), dict(random_crop=True, augment=True)]:
        a = load_and_preprocess(p, 32, rng=np.random.RandomState(5), use_native=True, **kwargs)
        b = load_and_preprocess(p, 32, rng=np.random.RandomState(5), use_native=False, **kwargs)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_native_backend_falls_back_to_cv2_for_bmp(tmp_path):
    """The native decoder reads JPEG and PNG only: a BMP goes through cv2,
    with the same draws after the RNG rewind, in both the single-image and
    the batch path."""
    _need_native()
    d = tmp_path / "d"
    d.mkdir()
    p = str(d / "img.bmp")
    cv2.imwrite(p, np.random.RandomState(3).randint(0, 255, (40, 56, 3), np.uint8))
    assert native.probe(p) is None
    a = load_and_preprocess(p, 16, random_crop=True, augment=True, rng=np.random.RandomState(5), use_native=True)
    b = load_and_preprocess(p, 16, random_crop=True, augment=True, rng=np.random.RandomState(5), use_native=False)
    np.testing.assert_array_equal(a, b)
    with TrainFeeder([f"{p} 1\n"], batch_size=1, im_side=16, shuffle=False, random_crop=False,
                     preprocess=False) as f:
        x, y = f.dequeue()
        assert x.shape == (1, 16, 16, 3) and y[0] == 1 and x.any()


def test_native_probe_and_decode(tmp_path):
    _need_native()
    p = _write_imgs(tmp_path / "d", "c0", 1, hw=(33, 44))[0]
    assert native.probe(p) == (33, 44)
    assert native.probe(str(tmp_path / "nope.png")) is None
    out = native.load_preprocess(p, None, 16)
    assert out is not None and out.shape == (16, 16, 3)


def test_native_fast_decode_jpeg(tmp_path):
    """DCT-scaled decode: right shape, close to the exact path on smooth
    content, and identical when no downscale applies."""
    _need_native()
    d = tmp_path / "d"
    d.mkdir()
    yy, xx = np.mgrid[0:1024, 0:1280]
    im = np.stack([(yy // 4) % 256, (xx // 5) % 256, ((yy + xx) // 8) % 256], -1)
    p = str(d / "big.jpg")
    cv2.imwrite(p, im.astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 95])
    exact = native.load_preprocess(p, (128, 0, 1024, 1024), 224)
    fast = native.load_preprocess(p, (128, 0, 1024, 1024), 224, min_decode_side=224)
    assert fast.shape == (224, 224, 3)
    assert np.abs(exact.astype(int) - fast.astype(int)).mean() < 4.0
    small = str(d / "small.jpg")
    cv2.imwrite(small, im[:256, :256].astype(np.uint8))
    np.testing.assert_array_equal(native.load_preprocess(small, None, 224),
                                  native.load_preprocess(small, None, 224, min_decode_side=224))


def test_feeder_producer_death_surfaces_in_dequeue(tmp_path):
    """A malformed list line kills the producer thread; dequeue() raises the
    recorded cause instead of blocking forever."""
    paths = _write_imgs(tmp_path / "d", "c0", 2)
    lines = [f"{paths[0]} 0\n", "stray-line-without-a-label\n"]
    with TrainFeeder(lines, batch_size=2, im_side=8, shuffle=False, random_crop=False, preprocess=False) as f:
        with pytest.raises(RuntimeError, match="producer thread died"):
            for _ in range(8):
                f.dequeue()


# -- parity with roomnet_tpu ---------------------------------------------------


@pytest.fixture
def mixed_dir(tmp_path):
    """Two classes of JPEG, PNG and BMP files, wide, tall and square, with
    spaces in some names, and an unreadable file."""
    rng = np.random.RandomState(11)
    for c, cls in enumerate(("Kitchen", "Bedroom")):
        d = tmp_path / "data" / cls
        d.mkdir(parents=True)
        for i, (h, w, ext) in enumerate([(40, 56, "jpg"), (57, 38, "png"), (33, 33, "png"), (45, 61, "bmp"),
                                         (48, 36, "jpg"), (30, 50, "png"), (52, 52, "jpg")]):
            cv2.imwrite(str(d / f"img {c}{i}.{ext}"), rng.randint(0, 256, (h, w, 3), np.uint8))
    (tmp_path / "data" / "Kitchen" / "broken.jpg").write_text("not an image")
    return tmp_path


def test_extract_fpaths_writes_the_jax_lists(mixed_dir):
    data = str(mixed_dir / "data")
    out = {}
    for name, fn in (("jax", jds.extract_fpaths), ("port", extract_fpaths)):
        files = [str(mixed_dir / f"{name}_{f}") for f in ("train.txt", "val.txt", "labels.json")]
        ret = fn(data, *files, seed=3)
        out[name] = (ret, [open(f).read() for f in files])
    assert out["port"] == out["jax"]
    assert json.loads(out["port"][1][2]) == {"Bedroom": 0, "Kitchen": 1}
    assert len(out["port"][0][0]) == 12 and len(out["port"][0][1]) == 2  # 7 readable files a class
    with pytest.raises(FileNotFoundError):
        extract_fpaths(str(mixed_dir / "nowhere"), *(str(mixed_dir / f) for f in ("a", "b", "c")))


@pytest.mark.parametrize("backend", ["native", "cv2"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_feeder_batches_equal_the_jax_feeders(mixed_dir, monkeypatch, backend, mode):
    """x, y, batch_fpaths and train_state of every batch over two epochs (and
    the first batch of the third) equal the JAX feeder's, byte for byte."""
    if backend == "native":
        _need_native()
        if not jnative.available():
            pytest.skip("the JAX package's native library is not built here")
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    lines, _ = jds.extract_fpaths(str(mixed_dir / "data"), str(mixed_dir / "t.txt"), str(mixed_dir / "v.txt"),
                                  str(mixed_dir / "l.json"), train_frac=1.0, seed=0)
    lines = lines + [f"{mixed_dir / 'data' / 'Kitchen' / 'broken.jpg'} 1\n"]
    train = mode == "train"
    kw = dict(batch_size=4, im_side=24, shuffle=train, random_crop=train, preprocess=train, seed=9,
              batches_per_queue=4, decode_workers=3)
    with jld.TrainFeeder(lines, **kw) as jf, TrainFeeder(lines, **kw) as tf:
        assert tf.batches_per_epoch == jf.batches_per_epoch == 3
        for _ in range(2 * tf.batches_per_epoch + 1):
            (jx, jy), (tx, ty) = jf.dequeue(), tf.dequeue()
            assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
            np.testing.assert_array_equal(tf.batch_fpaths, jf.batch_fpaths)
            assert tf.train_state == jf.train_state
            assert tf.last_batch_synthetic == jf.last_batch_synthetic


# -- device staging on the CPU -------------------------------------------------


def test_staging_on_the_cpu_hands_the_arrays_through():
    rng = np.random.RandomState(1)
    x, y = rng.randint(0, 256, (3, 8, 8, 3), np.uint8), np.arange(3, dtype=np.int32)
    staged = to_device_async((x, y[::-1]), torch.device("cpu"))
    assert staged.event is None
    tx, ty = on_stream(staged)
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_array_equal(ty.numpy(), y[::-1])
    assert ty.dtype == torch.int32


def test_device_prefetch_yields_every_batch_in_order():
    rng = np.random.RandomState(2)
    batches = [(rng.randint(0, 256, (2, 4, 4, 3), np.uint8), rng.randint(0, 6, 2).astype(np.int32))
               for _ in range(5)]
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for (x, y), (gx, gy) in zip(batches, got):
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
    assert list(device_prefetch(iter([]), device="cpu")) == []


def test_device_prefetch_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch(iter([(np.zeros(1),)])))
