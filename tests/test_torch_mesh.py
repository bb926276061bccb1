"""The port's mesh (`parallel/mesh.py`), its gather and inventory
(`parallel/comm_model.py`), and the device repair (`device.py`): plain
"cuda" and None resolve to the current card's index, a missing card
raises, and the per-device caches (the constant memory of Poseidon and the
pairing, the uploaded tables) see one key per physical device.  CUDA is
faked here: `torch.cuda.is_available`, `current_device` and `device_count`
are patched, the kernel library is a stub that counts constant loads, and
`Tensor.to` keeps a tensor on the CPU where a CUDA device is asked for.
`predict_efficiency` equals the JAX package's formula on the same
arguments and has no default taken on or for a TPU.

Tolerance: exact."""

import contextlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from snark_verifier_tpu_torch import device as device_mod
from snark_verifier_tpu_torch.device import device_key, resolve_device
from snark_verifier_tpu_torch.ff import fr_tape
from snark_verifier_tpu_torch.hash import keccak_device, poseidon
from snark_verifier_tpu_torch.pairing import pairing
from snark_verifier_tpu_torch.parallel import Mesh
from snark_verifier_tpu_torch.parallel import comm_model
from snark_verifier_tpu_torch.parallel.mesh import all_gather, assemble, recording, split
from snark_verifier_tpu_torch.sdk.srs import Srs, toy_srs
from snark_verifier_tpu_torch.verifier.plonk import plan as plan_mod

PKG = Path(__file__).resolve().parent.parent / "snark_verifier_tpu_torch"


@pytest.fixture
def cards(monkeypatch):
    """Two fake CUDA cards; returns a setter of the current one."""
    state = {"current": 0}
    monkeypatch.setenv("SNARK_AOT", "0")  # the warm-start cache stays off
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    real_to = torch.Tensor.to

    def to(self, *args, **kw):  # the CPU stands in for the card
        dev = args[0] if args else kw.get("device")
        if isinstance(dev, (str, torch.device)) and torch.device(dev).type == "cuda":
            return self
        return real_to(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to)

    def select(i):
        state["current"] = i

    return select


def test_resolve_device_indexes_cuda(cards):
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    cards(1)
    assert resolve_device(None) == resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_key("cuda") == "cuda:1" and device_key(torch.device("cuda", 0)) == "cuda:0"
    with pytest.raises(RuntimeError):
        resolve_device("cuda:2")


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for d in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError):
            resolve_device(d)
    with pytest.raises(RuntimeError):
        Mesh(["cuda:0"] * 2, ("batch",))


class _Lib:
    def __init__(self):
        self.poseidon = self.pairing = 0

    def svt_poseidon_load_constants(self, rc, mds):
        self.poseidon += 1
        return 0

    def svt_pairing_load_constants(self, tab):
        self.pairing += 1
        return 0


def test_constants_load_once_per_physical_device(cards, monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(poseidon, "load_library", lambda: lib)
    monkeypatch.setattr(pairing, "load_library", lambda: lib)
    monkeypatch.setattr(poseidon, "_loaded", set())
    monkeypatch.setattr(pairing, "_loaded", set())
    for d in ("cuda", "cuda:0", torch.device("cuda", 0), torch.device("cuda")):
        poseidon._library(d)
        pairing._library(d)
    assert (lib.poseidon, lib.pairing) == (1, 1)
    cards(1)  # "cuda" now means card 1: its constant memory is still empty
    for d in ("cuda", "cuda:1", torch.device("cuda")):
        poseidon._library(d)
        pairing._library(d)
    assert (lib.poseidon, lib.pairing) == (2, 2)
    assert poseidon._loaded == pairing._loaded == {"cuda:0", "cuda:1"}


def test_device_tables_key_on_the_physical_device(cards, monkeypatch):
    s = toy_srs(4)
    srs = Srs(g1_powers=s.g1_powers, g2=s.g2, s_g2=s.s_g2)
    monkeypatch.setattr(keccak_device, "_tables", {})
    monkeypatch.setattr(poseidon, "_consts", {})
    monkeypatch.setattr(plan_mod, "_ICK_BASES", {})
    ft = fr_tape.FrTape(np.zeros((1, 4), np.int32), np.zeros((1, 8), np.int32), [], [], 1)
    for d in ("cuda", "cuda:0", torch.device("cuda", 0)):
        srs.g_dev(d)
        srs.decider_coeffs(d)
        ft.device_arrays(d)
        keccak_device._device_tables(d)
        poseidon._limb_constants(d)
        plan_mod._ick_bases([s.g1_powers[1]], d)
    cards(1)
    srs.g_dev("cuda")
    ft.device_arrays("cuda")
    keccak_device._device_tables("cuda")
    poseidon._limb_constants("cuda")
    for cache in (srs._g_words, ft._dev, keccak_device._tables, poseidon._consts):
        assert set(cache) == {"cuda:0", "cuda:1"}, cache.keys()
    assert set(srs._decider) == {"cuda:0"}
    assert [k[1] for k in plan_mod._ICK_BASES] == ["cuda:0"]


def test_no_cache_keys_on_an_unresolved_device():
    pat = re.compile(r"(key = .*str\((device|dev)\)|_loaded\.add\(str\()")
    bad = [f"{p.relative_to(PKG)}:{i}" for p in PKG.rglob("*.py")
           for i, line in enumerate(p.read_text().splitlines(), 1) if pat.search(line)]
    assert bad == []


def test_mesh_shape_axes_and_errors():
    m = Mesh(np.array(["cpu"] * 6).reshape(2, 3), ("batch", "points"))
    assert m.shape == {"batch": 2, "points": 3} and m.size == 6
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert m.first == torch.device("cpu")
    assert m.along("points").shape == {"points": 3} and m.along("batch").shape == {"batch": 2}
    m.synchronize()  # no CUDA device: nothing to wait for
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 2, ("a", "b"))
    with pytest.raises(ValueError):
        Mesh([["cpu"]], ("a", "a"))
    with pytest.raises(ValueError):
        m.axis("model")
    assert [x.tolist() for x in split(torch.arange(6), m, "points")] == [[0, 1], [2, 3], [4, 5]]
    assert split(list("abcd"), m, "batch") == [["a", "b"], ["c", "d"]]
    with pytest.raises(ValueError):
        split(list("abcd"), m, "points")


def test_mesh_of_one_card_listed_several_times(cards):
    m = Mesh(["cuda"] * 4, ("batch",))
    assert [str(d) for d in m.devices.flat] == ["cuda:0"] * 4
    with pytest.raises(RuntimeError):
        Mesh(["cuda:0", "cuda:3"], ("batch",))


def test_all_gather_records_every_group():
    m = Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("batch", "points"))
    parts = np.empty((2, 2), dtype=object)
    for pos in np.ndindex(2, 2):
        parts[pos] = torch.full((3, 3, 8), 10 * pos[0] + pos[1], dtype=torch.int32)
    with recording() as ops:
        out = all_gather(parts, m, "points")
        with recording() as inner:
            flat = all_gather([torch.tensor(True)] * 2, m.along("batch"), "batch").item()
    assert out.shape == (2,) and [tuple(t.shape) for t in out] == [(2, 3, 3, 8)] * 2
    assert [int(t[j, 0, 0, 0]) for t in out for j in range(2)] == [0, 1, 10, 11]
    assert flat.tolist() == [True, True]
    assert ops == [{"op": "all-gather", "type": "s32[2,3,3,8]", "bytes": 2 * 3 * 3 * 8 * 4},
                   {"op": "all-gather", "type": "pred[2]", "bytes": 2}]
    assert inner == ops[1:]
    with pytest.raises(ValueError):
        all_gather([torch.zeros(2), torch.zeros(3)], m.along("batch"), "batch")
    with pytest.raises(ValueError):
        all_gather([torch.zeros(2)] * 3, m.along("batch"), "batch")
    assert assemble([torch.zeros(2), torch.ones(1)], m).tolist() == [0, 0, 1]


def test_predict_efficiency_equals_the_jax_formula():
    from snark_verifier_tpu.parallel.comm_model import predict_efficiency as j_predict

    params = inspect.signature(comm_model.predict_efficiency).parameters
    for name in ("chip_points_per_sec", "alpha_link_s", "ecadd_row_s"):
        assert params[name].default is inspect.Parameter.empty
    assert params["bw_bytes_per_sec"].default == comm_model.NVLINK_BYTES_PER_S == 450e9
    assert params["coll_bytes_per_device"].default == 97
    for n, d in ((1 << 20, 2), (1 << 18, 4), (1 << 10, 8), (1 << 20, 256)):
        kw = dict(chip_points_per_sec=4.5e7, alpha_link_s=2e-6, ecadd_row_s=3.5e-5,
                  coll_bytes_per_device=97, bw_bytes_per_sec=450e9)
        assert comm_model.predict_efficiency(n, d, **kw) == j_predict(n, d, **kw)
