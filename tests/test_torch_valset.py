"""tools/valset_torch.py, the port's val-scale parity run, on the CPU.

The 56 logits-sample images of tests/golden/valset_golden.npz that need no
reference documentation PNG, regenerated by tools/valset.py on a process
pool: their cv2 pixels hash to the tool's pinned digest, the port's f32
forward on them is within 1e-4 of the fixture's TF logits (1.29e-5 measured)
with argmax equal to `argmax_cv2`, and the JAX forward on the same pixels is
within 1e-4 of the port's. The port's decoders give tools/valset.py's pixels;
the drift guards raise on a tampered JPEG and a tampered digest;
`undocumented_indices()` is exactly the images whose bytes are the same with
and without a stand-in documentation directory; `run` scores a list of
indices as the fixture says, and `main` exits 1 where a gate fails.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest

from roomnet_tpu.models.roomnet import forward as jax_forward
from roomnet_tpu.models.roomnet import normalize_bgr_uint8 as jax_normalize
from roomnet_tpu_torch.params.schema import load_npz
from tools import valset as JV
from tools import valset_torch as V

cv2 = pytest.importorskip("cv2")
TOL = 1e-4


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(V.GOLDEN))


@pytest.fixture(scope="module")
def built(tmp_path_factory, golden):
    """Image 0 and the 56 undocumented sample images, on two processes."""
    d = str(tmp_path_factory.mktemp("valset"))
    return V.build(d, {0} | set(V.sample_indices(golden)), workers=2)


@pytest.fixture(scope="module")
def sample_pixels(built, golden):
    return V.check_pixels(built, golden)


def test_the_sample_is_the_56_undocumented_logits_images(golden):
    sample = V.sample_indices(golden)
    assert len(sample) == 56 and all(i % 16 not in (11, 12) for i in sample)
    assert set(sample) == set(golden["logits_sample_idx"].tolist()) & set(V.undocumented_indices())
    assert len(V.undocumented_indices()) == 1609


def test_port_f32_logits_match_the_tf_graph(golden, sample_pixels):
    logits = V.logits_of(load_npz(V.PARAMS, device="cpu"), sample_pixels, "cpu")
    at = {int(i): k for k, i in enumerate(golden["logits_sample_idx"])}
    rows = [at[i] for i in V.sample_indices(golden)]
    np.testing.assert_allclose(logits, golden["logits_sample"][rows], rtol=0, atol=TOL)
    np.testing.assert_array_equal(logits.argmax(-1), golden["argmax_cv2"][V.sample_indices(golden)])
    np.testing.assert_array_equal(logits.argmax(-1), golden["logits_sample"][rows].argmax(-1))


def test_jax_forward_on_the_same_pixels_matches_the_port(sample_pixels, converted_variables):
    port = V.logits_of(load_npz(V.PARAMS, device="cpu"), sample_pixels, "cpu")
    want = np.asarray(jax.jit(lambda v, x: jax_forward(v, jax_normalize(x)))(converted_variables, sample_pixels))
    np.testing.assert_allclose(port, want, rtol=0, atol=TOL)


# The images whose bf16 argmax differs from the TF graph's on the H100
# (chip_smoke.py phase 14 (b), cv2 decode), and the JAX package's bf16
# argmax of each on the same pixels (FAST_CONFIG on the CPU).
CARD_BF16_FLIPS = (9, 125, 273, 350, 462, 510, 532, 548, 852, 878, 1556)
BF16_TOL = 0.15  # the bf16 parity rule's fixed |logit| limit


def test_card_bf16_flips_are_bf16s_not_the_kernels(tmp_path, golden, converted_variables):
    """On the card's flipped images the port's bf16 logits through the plain
    versions are within BF16_TOL of the JAX package's bf16 logits, and both
    flip image 878, whose f32 top-2 margin (0.765) is the largest: bf16
    moves its logits that far in both packages, kernels or none."""
    from roomnet_tpu.models.roomnet import FAST_CONFIG as JAX_FAST

    paths = V.build(str(tmp_path), CARD_BF16_FLIPS, workers=1)
    px = V.decode_cv2([paths[i] for i in CARD_BF16_FLIPS])
    variables = load_npz(V.PARAMS, device="cpu")
    f32 = V.logits_of(variables, px, "cpu")
    port = V.bf16_logits_of(variables, px, "cpu")
    want = np.asarray(jax.jit(lambda v, x: jax_forward(v, jax_normalize(x), JAX_FAST))(converted_variables, px),
                      np.float32)
    for k, i in enumerate(CARD_BF16_FLIPS):
        top2 = np.sort(f32[k])[-2:]
        print(f"valset {i}: TF argmax {golden['argmax_cv2'][i]}, f32 top-2 margin {top2[1] - top2[0]:.4f}; "
              + "; ".join(f"{name} {np.array2string(lg[k], precision=4)} (argmax {lg[k].argmax()})"
                          for name, lg in (("f32", f32), ("port bf16", port), ("JAX bf16", want))))
    print(f"port bf16 (plain) against JAX bf16: max |d| {np.abs(port - want).max():.4g}")
    np.testing.assert_array_equal(f32.argmax(-1), golden["argmax_cv2"][list(CARD_BF16_FLIPS)])
    np.testing.assert_allclose(port, want, rtol=0, atol=BF16_TOL)
    k = CARD_BF16_FLIPS.index(878)
    assert port[k].argmax() == want[k].argmax() != golden["argmax_cv2"][878]


def test_decoders_give_the_jax_tools_pixels(built, golden):
    paths = [built[i] for i in V.sample_indices(golden)[:16]]
    np.testing.assert_array_equal(V.decode_cv2(paths), JV.decode_cv2(paths))
    from roomnet_tpu.data import native as jnative
    from roomnet_tpu_torch.data import native as tnative

    if not (jnative.available() and tnative.available()):
        pytest.skip("the native decoder is not built on this host")
    np.testing.assert_array_equal(V.decode_native(paths), JV.decode_native(paths))


def test_guards_pass_on_the_fixtures_inputs(built, golden):
    V.check_guards(built, golden)
    assert V.file_sha256(built[0]) == JV.first_image_sha256([built[0]])


def test_guards_fail_on_a_tampered_jpeg(built, golden, tmp_path):
    bad = str(tmp_path / "val_0000.jpg")
    data = bytearray(open(built[0], "rb").read())
    data[-3] ^= 1
    open(bad, "wb").write(bytes(data))
    with pytest.raises(V.DriftError, match="image 0's JPEG sha256 .* no model was run"):
        V.check_guards({**built, 0: bad}, golden)


@pytest.mark.parametrize("decoder", ["cv2", "native"])
def test_pixel_guard_fails_on_a_tampered_digest(built, golden, decoder):
    if decoder == "native" and V.backend() != "native":
        pytest.skip("the native decoder is not built on this host")
    digests = {**V.SAMPLE_PIXEL_SHA256, decoder: "0" * 64}
    with pytest.raises(V.DriftError, match="decoder drift"):
        V.check_pixels(built, golden, digests)


def test_undocumented_indices_are_the_images_that_need_no_png(tmp_path, monkeypatch):
    """Indices 0-47 (every kind three times) built with a stand-in
    documentation directory of two PNGs and with none: the same bytes
    exactly at the undocumented indices."""
    doc = next(c for c in JV.build_valset_jpegs.__code__.co_consts
               if isinstance(c, str) and c.endswith("documentation"))
    stand_in = tmp_path / "doc"
    stand_in.mkdir()
    rng = np.random.RandomState(0)
    for k in range(2):
        cv2.imwrite(str(stand_in / f"page_{k}.png"), rng.randint(0, 256, size=(90, 120, 3), dtype=np.uint8))
    real_isdir, real_listdir, real_imread = os.path.isdir, os.listdir, cv2.imread

    def redirect(p):
        return str(stand_in) + str(p)[len(doc):] if str(p).startswith(doc) else p

    def with_docs(present: bool, out: str):
        monkeypatch.setattr(os.path, "isdir", lambda p: present if str(p) == doc else real_isdir(p))
        monkeypatch.setattr(os, "listdir", lambda p: real_listdir(redirect(p)))
        monkeypatch.setattr(cv2, "imread", lambda p, *a: real_imread(redirect(p), *a))
        assert JV.doc_dir_available() == present
        return V.build(str(tmp_path / out), range(48), workers=1)

    with_png, without = with_docs(True, "with"), with_docs(False, "without")
    same = {i for i in range(48) if open(with_png[i], "rb").read() == open(without[i], "rb").read()}
    assert same == set(V.undocumented_indices()) & set(range(48))
    assert len(same) == 42


def test_indices_that_need_the_pngs_are_refused(golden, monkeypatch):
    monkeypatch.setattr(V, "doc_dir_available", lambda: False)
    for indices in ("all", [0, 11], [27]):
        with pytest.raises(V.DriftError, match="documentation"):
            V.resolve_indices(indices, golden)
    assert V.resolve_indices([5, 3, 5], golden) == [3, 5]
    assert V.resolve_indices("undocumented", golden) == V.undocumented_indices()
    with pytest.raises(ValueError):
        V.resolve_indices("some", golden)


def test_run_scores_a_list_as_the_fixture_says(golden):
    """Indices 0-10 on the CPU: the f32 and bf16 argmax of predict_paths
    against the fixture's, counted by the run as the JAX test counts them."""
    idx = list(range(11))
    r = V.run("cpu", indices=idx, workers=2)
    assert r["scored"] == 11 and r["argmax_key"] == V.backend_key(golden) and r["decoder"] == V.backend()
    assert r["f32_mismatches"] == 0 and r["sample_logits_max_abs_diff"] <= TOL
    assert r["bf16_flips"] == len(r["bf16_flip_indices"]) and set(r["bf16_flip_indices"]) <= set(idx)
    assert r["bf16_flip_rate"] == r["bf16_flips"] / 11
    assert r["ok"] == (r["bf16_flips"] < 0.01 * 11)
    assert r["forwards"] == {"f32": 2, "bf16": 1}
    assert set(r["bf16_flip_f32_top2_margins"]) == set(r["bf16_flip_logits"]) == set(r["bf16_flip_indices"])
    for i, lg in r["bf16_flip_logits"].items():
        assert lg["bf16"] == lg["bf16_plain_cpu"]  # on the CPU both are the plain versions
        assert np.argmax(lg["bf16"]) != golden["argmax_cv2"][i] == np.argmax(lg["f32"])


@pytest.mark.parametrize("ok,code", [(True, 0), (False, 1)])
def test_main_exits_1_where_a_gate_fails(monkeypatch, capsys, ok, code):
    calls = []
    result = {"scored": 1609, "decoder": "cv2", "argmax_key": "argmax_cv2", "f32_mismatches": 0,
              "bf16_flips": 3, "bf16_flip_rate": 3 / 1609, "sample_logits_max_abs_diff": 1e-5, "sample_images": 56,
              "build_s": 1.0, "score_s": 1.0, "ok": ok}
    monkeypatch.setattr(V, "run", lambda *a: calls.append(a) or result)
    assert V.main(["--device", "cpu", "--out-dir", "/o"]) == code
    assert calls == [("cpu", "/o", "undocumented")]
    assert json.loads(capsys.readouterr().out) == result


def test_the_tool_runs_as_a_script_without_a_card():
    """`python tools/valset_torch.py` on a host without CUDA raises before
    it builds anything (no --device)."""
    import subprocess

    proc = subprocess.run([sys.executable, os.path.join(V.REPO, "tools", "valset_torch.py")], capture_output=True,
                          text=True, timeout=120, cwd=V.REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
