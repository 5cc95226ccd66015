"""The architecture folders (benchmark/arch/<arch>/): no file outside
RoomNet's folder names RoomNet's pieces, and what RoomNet's cells read is
frozen: the work counts, the seeded traffic and weights, and the
reference's probabilities read as they did when the code moved into
benchmark/arch/roomnet/ (the numbers below were computed before the move,
on the CPU)."""

from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.lib import harness, images

ROOMNET = harness.load_arch("roomnet")
SEED = 2**33 + 11

# Names that only RoomNet's folder may use: the reference's old module path
# and the program's configuration and classifier.
ROOMNET_PIECES = ("reference.model", "reference import model", "RoomNetConfig", "RoomNetClassifier")


def test_only_roomnets_folder_names_its_pieces():
    bench = harness.ROOT / "benchmark"
    own = bench / "arch" / "roomnet"
    found = []
    for path in bench.rglob("*"):
        if not path.is_file() or own in path.parents or path == pathlib.Path(__file__).resolve() \
                or path.suffix not in (".py", ".md", ".json"):
            continue
        text = path.read_text()
        found += [f"{path.relative_to(bench)}: {piece}" for piece in ROOMNET_PIECES if piece in text]
    assert not found


def config(name: str) -> dict:
    return json.loads((harness.ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:32]


@pytest.mark.parametrize("name,batch,launches,ideal_s", [
    ("roomnet-224-bf16", 64, "5b8b88a7067c618a5c7db41a8b57e843", 0.0002983235419373105),
    ("roomnet-224-bf16", 256, "fed83972ef62c0810dc858630ce48411", 0.001193294167749242),
    ("roomnet-224", 64, "88a050919cb6c3788d7751f3068263e8", 0.0018703583683560379),
    ("roomnet-224", 256, "2e875ddbdff023ca4f7d1ac500f9ecec", 0.0074814334734241515)])
def test_the_work_counts_are_frozen(name, batch, launches, ideal_s):
    cfg = config(name)
    assert digest(json.dumps(ROOMNET.work.launches(cfg, batch), sort_keys=True).encode()) == launches
    assert ROOMNET.work.forward_ideal_s(cfg, batch) == ideal_s


def _tree(t, path=""):
    """(path, tensor or None) of a nested tree, in a fixed order."""
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _tree(t[k], f"{path}{k}/")
    elif isinstance(t, list):
        for i, e in enumerate(t):
            yield from _tree(e, f"{path}{i}/")
    else:
        yield path, t


FROZEN = {
    "tiny": {
        "n": 16, "pool": "331083d816877812891b382bf8d5baa6", "glorot": "40d407d928d3da7069a849587bec679b",
        "nest": "ad45b1c4a1b4588dc59acac0b5116322",
        "calibrated": {"dense/0/bn/mean": 1.5921623036265373, "dense/0/bn/var": 0.14380096620880067,
                       "dense/1/bn/mean": 2.191101662814617, "dense/1/bn/var": 2.233555296435952,
                       "dense/2/kernel": -2.4819723145337775, "dense/2/bias": 17.99999976158142},
        "probs": [[0.122492403, 0.13554953, 0.120856643, 0.03577837, 0.33509469, 0.250228375],
                  [0.193411157, 0.028881829, 0.013283237, 0.228831872, 0.027806101, 0.507785797],
                  [0.198897451, 0.107254423, 0.115963735, 0.236093432, 0.259810418, 0.081980459]]},
    "224": {
        "n": 6, "pool": "da9c30ab27949a2da6c3ad763a904e96", "glorot": "75bd2acefbc50e96195a72b32296d314",
        "nest": "6d8b3b810f7e23080601843b2fb4d9b1",
        "calibrated": {"dense/0/bn/mean": 0.7752088685519993, "dense/0/bn/var": 0.011695049109221145,
                       "dense/1/bn/mean": 3.3557664528489113, "dense/1/bn/var": 1.3463583588600159,
                       "dense/2/bn/mean": 3.3624671548604965, "dense/2/bn/var": 2.153365671634674,
                       "dense/3/kernel": 2.732912940904498, "dense/3/bias": 18.0},
        "probs": [[0.205534488, 0.271592557, 0.055299316, 0.310848266, 0.093246765, 0.063478567],
                  [0.130974844, 0.170974761, 0.410506874, 0.108115226, 0.08702004, 0.092408232],
                  [0.425596088, 0.044982601, 0.072898567, 0.109555133, 0.041620281, 0.305347353]]},
}


@pytest.mark.parametrize("label", sorted(FROZEN))
def test_the_traffic_weights_and_reference_are_frozen(label):
    want = FROZEN[label]
    cfg = dict(ROOMNET.reference.TINY, precision="f32") if label == "tiny" else config("roomnet-224")
    x, y = images.pool(SEED, want["n"], cfg["im_side"], 4, 16, "cpu")
    assert digest(x.tobytes() + y.astype(np.int32).tobytes()) == want["pool"]
    g = ROOMNET.weights.glorot(cfg, SEED, "cpu")
    assert digest(b"".join(t.numpy().tobytes() for t in g.values())) == want["glorot"]
    nested = ROOMNET.weights.nest(g, cfg)
    assert digest(b"".join(p.encode() + (b"" if t is None else t.numpy().tobytes())
                           for p, t in _tree(nested))) == want["nest"]
    v = ROOMNET.weights.make(cfg, SEED, x, "cpu")
    changed = {k: float(t.double().sum()) for k, t in v.items() if not torch.equal(t, g[k])}
    assert changed == pytest.approx(want["calibrated"], rel=1e-6)
    assert ROOMNET.reference.probs(v, x[:3], cfg, "f32") == pytest.approx(np.array(want["probs"]), abs=1e-6)
