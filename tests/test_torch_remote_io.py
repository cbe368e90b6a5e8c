"""The port's remote-path filesystem (``utils/remote_io.py``) and its
checkpoint URIs (``train/checkpoint.py``): the cases of
``tests/test_remote_io.py`` and ``tests/test_checkpoint_uri.py`` against
partner_tpu_torch, plus a JAX ``state.pkl`` through ``memory://`` and
``file://``, and the zoo file the JAX package reads serving both. Local
files and ``file://`` URLs only: no network."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from partner_tpu_torch.utils import remote_io


@pytest.fixture
def memfs():
    fs = remote_io.MemoryFileSystem()
    remote_io.register("memtest", fs)
    return fs


def test_local_roundtrip(tmp_path):
    p = str(tmp_path / "a" / "b.bin")
    remote_io.write_bytes(p, b"hello")
    assert remote_io.exists(p)
    assert remote_io.read_bytes(p) == b"hello"
    assert remote_io.listdir(str(tmp_path / "a")) == ["b.bin"]
    assert remote_io.open_read(p).read() == b"hello"


def test_memory_backend(memfs):
    remote_io.write_bytes("memtest://bucket/x/y.pkl", b"\x01\x02")
    assert remote_io.exists("memtest://bucket/x/y.pkl")
    assert remote_io.read_bytes("memtest://bucket/x/y.pkl") == b"\x01\x02"
    assert remote_io.listdir("memtest://bucket/x") == ["y.pkl"]
    assert remote_io.exists("memtest://bucket/x")  # prefix exists
    remote_io.delete_tree("memtest://bucket/x")
    assert not remote_io.exists("memtest://bucket/x/y.pkl")
    with pytest.raises(FileNotFoundError):
        remote_io.read_bytes("memtest://bucket/x/y.pkl")


def test_unregistered_scheme_raises():
    with pytest.raises(ValueError, match="no filesystem registered"):
        remote_io.read_bytes("nosuch://a/b")


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 4, generator=g),
            "bn.running_mean": torch.randn(4, generator=g)}


@pytest.mark.parametrize("where", ["memory", "local"])
def test_checkpoint_roundtrip(tmp_path, memfs, where):
    """save -> latest -> load, with the Adam state, ``keep`` pruning and a
    ``latest`` pointer path, through a remote scheme and locally."""
    from partner_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                    load_checkpoint,
                                                    save_checkpoint)

    work = ("memtest://ckpts/run1" if where == "memory"
            else str(tmp_path / "run1"))
    opt = {"count": 7, "mu": {"w": torch.ones(4, 4)},
           "nu": {"w": torch.full((4, 4), 2.0)}}
    for step in (3, 7, 9):
        path = save_checkpoint(work, step, _state(step), meta={"epoch": step},
                               keep=2, opt_state=opt)
    assert latest_checkpoint(work) == path
    assert remote_io.listdir(work) == ["ckpt_00000007", "ckpt_00000009",
                                       "latest"]
    for p in (path, work + "/latest", path + "/state.pt"):
        payload, meta = load_checkpoint(p)
        assert meta == {"epoch": 9} and payload["step"] == 9
        for k, v in _state(9).items():
            assert torch.equal(payload["state_dict"][k], v)
        assert payload["opt_state"]["count"] == 7
        assert torch.equal(payload["opt_state"]["nu"]["w"], opt["nu"]["w"])
    assert latest_checkpoint(work + "x") is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(work + "/ckpt_00000003")


def _jax_payload():
    return {"step": 3, "params": {"Dense_0": {"kernel": np.ones(
        (2, 3), np.float32)}}, "batch_stats": {}, "opt_state": {}}


def test_jax_payload_through_memory_and_file_url(tmp_path, memfs,
                                                 monkeypatch):
    """A JAX ``state.pkl`` from a remote store, and by a ``file://`` URL
    (cached: the source may go after the first load)."""
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    data = pickle.dumps(_jax_payload())
    remote_io.write_bytes("memtest://zoo/ckpt_00000003/state.pkl", data)
    payload, meta = load_checkpoint("memtest://zoo/ckpt_00000003")
    assert payload["step"] == 3 and meta is None
    assert torch.equal(payload["state_dict"]["Dense_0.weight"],
                       torch.ones(3, 2))

    monkeypatch.setenv("PARTNER_TPU_CACHE", str(tmp_path / "cache"))
    src = tmp_path / "state.pkl"
    src.write_bytes(data)
    url = "file://" + str(src)
    payload, _ = load_checkpoint(url)
    assert payload["step"] == 3
    src.unlink()
    payload2, _ = load_checkpoint(url)
    assert payload2["step"] == 3
    assert len(os.listdir(tmp_path / "cache")) == 1


def test_file_url_of_port_checkpoint_caches(tmp_path, monkeypatch):
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)

    monkeypatch.setenv("PARTNER_TPU_CACHE", str(tmp_path / "cache"))
    path = save_checkpoint(str(tmp_path / "wd"), 5, _state(5))
    url = "file://" + os.path.join(path, "state.pt")
    payload, _ = load_checkpoint(url)
    os.remove(os.path.join(path, "state.pt"))
    again, _ = load_checkpoint(url)
    assert payload["step"] == again["step"] == 5
    for k, v in _state(5).items():
        assert torch.equal(again["state_dict"][k], v)


def test_modelzoo_name_resolves_through_registry(tmp_path, monkeypatch):
    """One zoo file (``PARTNER_TPU_MODEL_ZOO``) names a port step directory
    and a JAX payload by URL; the JAX package's loader reads the same file
    for its entry."""
    from partner_tpu.train.checkpoint import load_checkpoint as jax_load
    from partner_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    resolve_checkpoint_uri,
                                                    save_checkpoint)

    src = tmp_path / "zoo_ckpt.pkl"
    src.write_bytes(pickle.dumps(_jax_payload()))
    port = save_checkpoint(str(tmp_path / "wd"), 11, _state(11))
    zoo = tmp_path / "model_zoo.json"
    zoo.write_text(json.dumps({"partner_waymo_36e": "file://" + str(src),
                               "sparse_port": port}))
    monkeypatch.setenv("PARTNER_TPU_MODEL_ZOO", str(zoo))
    monkeypatch.setenv("PARTNER_TPU_CACHE", str(tmp_path / "cache"))
    payload, _ = load_checkpoint("modelzoo://partner_waymo_36e")
    assert payload["step"] == 3
    assert jax_load("modelzoo://partner_waymo_36e")[0]["step"] == 3
    assert resolve_checkpoint_uri("modelzoo://sparse_port") == port
    assert load_checkpoint("modelzoo://sparse_port")[0]["step"] == 11


def test_unknown_zoo_name_raises(tmp_path, monkeypatch):
    from partner_tpu_torch.train.checkpoint import load_checkpoint

    monkeypatch.setenv("PARTNER_TPU_MODEL_ZOO",
                       str(tmp_path / "missing.json"))
    with pytest.raises(KeyError):
        load_checkpoint("modelzoo://nope")
