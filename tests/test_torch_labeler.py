"""The port's labeling tool (roomnet_tpu_torch/data/labeler.py) against
roomnet_tpu's: with the same scripted UI keys on copies of one image
directory, labels.csv, log.txt and the per-label bins are byte-equal to the
JAX ImageLabeler's, through a first session, ESC, a resumed session and a
file name with a comma; the stdin UI re-prompts on blank input and maps 'q'
to ESC (tests/test_cli_and_misc.py:342-401's cases).
"""

import os

import numpy as np
import pytest

from roomnet_tpu.data import labeler as jlab
from roomnet_tpu_torch.data import labeler as tlab

cv2 = pytest.importorskip("cv2")


def image_dir(root, names) -> str:
    d = root / "imgs"
    d.mkdir(parents=True)
    for i, name in enumerate(names):
        cv2.imwrite(str(d / name), np.full((8, 8, 3), 40 * i, np.uint8))
    return str(d)


def tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def run_both(tmp_path, names, sessions, **kwargs) -> dict:
    """Each session (a list of keys, ESC included) through both packages'
    ImageLabeler on their own copy of the directory, `kwargs` passed to
    run_labeller; {package: (labeled counts, the -labelled tree)}."""
    out = {}
    for name, mod in (("jax", jlab), ("port", tlab)):
        d = image_dir(tmp_path / name, names)
        counts = []
        for keys in sessions:
            it = iter(keys)
            counts.append(mod.ImageLabeler(d, ui=lambda p: next(it)).run_labeller(**kwargs))
        out[name] = (counts, tree(d + "-labelled"))
    return out


def test_sessions_with_esc_and_resume_write_the_jax_files(tmp_path, capsys):
    names = [f"im{i}.png" for i in range(4)]
    got = run_both(tmp_path, names, [[ord("a"), ord("b"), tlab.ESC], [ord("a"), -1], [ord("c")]])
    assert got["port"] == got["jax"]
    counts, files = got["port"]
    assert counts == [2, 1, 1]
    assert sorted(files) == ["binned_files/97/im0.png", "binned_files/97/im2.png", "binned_files/98/im1.png",
                             "binned_files/99/im3.png", "labels.csv", "log.txt"]
    assert files["labels.csv"] == b"im0.png,97\r\nim1.png,98\r\nim2.png,97\r\nim3.png,99\r\n"
    assert b"Aborted by user" in files["log.txt"] and b"unreadable/unlabeled: im3.png" in files["log.txt"]


def test_bin_files_false_writes_the_jax_label_file_and_no_bins(tmp_path):
    names = [f"im{i}.png" for i in range(3)]
    got = run_both(tmp_path, names, [[ord("a"), tlab.ESC], [ord("b"), ord("c")]], bin_files=False)
    assert got["port"] == got["jax"]
    counts, files = got["port"]
    assert counts == [1, 2]
    assert sorted(files) == ["labels.csv", "log.txt"]  # no binned_files/
    assert files["labels.csv"] == b"im0.png,97\r\nim1.png,98\r\nim2.png,99\r\n"


def test_comma_file_name_resumes_as_the_jax_labeler_does(tmp_path):
    got = run_both(tmp_path, ["room,1.png", "room2.png"], [[ord("a"), ord("b")], []])
    assert got["port"] == got["jax"] and got["port"][0] == [2, 0]
    assert got["port"][1]["labels.csv"].startswith(b'"room,1.png",97')
    d = str(tmp_path / "port" / "imgs")
    assert tlab.ImageLabeler(d).extract_existing_labels() == ["room,1.png", "room2.png"]


@pytest.mark.parametrize("typed,key", [("  ", -1), ("", -1), (" q ", 27), ("Q", 27), ("b ", 98)])
def test_stdin_ui_as_the_jax_labelers(monkeypatch, typed, key):
    monkeypatch.setattr("builtins.input", lambda *_: typed)
    assert tlab._stdin_ui("x.png") == jlab._stdin_ui("x.png") == key
