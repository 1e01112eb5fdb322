"""The port's ``Setup.generate_srs_device(..., cache=True)`` on the CPU: the
device SRS is written to one ``.npz`` under ``Config.srs_cache_dir`` and read
back to equal tensors; it equals the JAX package's host SRS at canonical
values; its key is the port's own; a bad file is computed anew and
rewritten, never loaded. Tolerance: exact. The plain powers of tau take
seconds on the CPU, so the SRS is computed once for the file."""
import hashlib
import os

import numpy as np
import pytest
import torch

from baby_plonk_tpu.ops import g1_vec as jax_g1_vec
from baby_plonk_tpu.protocol.setup import Setup as JaxSetup
from baby_plonk_tpu_torch import config
from baby_plonk_tpu_torch.ops import g1_vec, srs
from baby_plonk_tpu_torch.protocol import setup as setup_mod
from baby_plonk_tpu_torch.protocol.setup import Setup, device_srs_path

from torch_port_util import affine, one_torch_thread  # noqa: F401  (fixture)

POWERS, TAU = 4, 0x5EED


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "_config", config.Config(srs_cache_dir=str(tmp_path)))
    return tmp_path


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(setup, file bytes) of the one SRS this file computes, with its cache
    file written by ``generate_srs_device``."""
    prev = config.get_config()
    config.set_config(config.Config(srs_cache_dir=str(tmp_path_factory.mktemp("srs"))))
    try:
        setup = Setup.generate_srs_device(POWERS, TAU, cache=True, device="cpu")
        with open(device_srs_path(POWERS, TAU), "rb") as f:
            data = f.read()
    finally:
        config.set_config(prev)
    return setup, data


def test_round_trip_equals_jax_host_srs(written, cache_dir):
    setup, data = written
    (cache_dir / os.path.basename(device_srs_path(POWERS, TAU))).write_bytes(data)
    loaded = Setup.generate_srs_device(POWERS, TAU, cache=True, device="cpu")
    assert os.listdir(cache_dir) == [os.path.basename(device_srs_path(POWERS, TAU))]
    got, want = loaded.device_points["cpu"], setup.device_points["cpu"]
    assert all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want))
    assert loaded.powers_of_x is None and loaded.srs_len() == POWERS and loaded.x_2 == setup.x_2
    jax_host = JaxSetup.generate_srs(POWERS, TAU, cache=False)
    assert affine(g1_vec.points_from_device(got)) == affine(jax_host.powers_of_x)
    assert loaded.x_2.to_compressed() == jax_host.x_2.to_compressed()
    # the file holds the (24, n) int32 tensors and x_2 as the JAX package's 288 bytes
    with np.load(device_srs_path(POWERS, TAU)) as f:
        assert sorted(f.files) == ["px", "py", "pz", "x2"]
        assert f["x2"].dtype == np.uint8 and f["x2"].tobytes() == setup_mod._g2_bytes(jax_host.x_2)


def test_key_is_the_ports_own(cache_dir):
    jax_key = hashlib.sha256(f"srs-dev-v2-{POWERS}-{TAU}-r{jax_g1_vec.FQ.radix}".encode()).hexdigest()[:24]
    assert setup_mod.DEVICE_SRS_KEY == "srs-dev-torch-v1"
    assert os.path.basename(device_srs_path(POWERS, TAU)) != f"{jax_key}.npz"
    assert os.path.dirname(device_srs_path(POWERS, TAU)) == str(cache_dir)
    assert device_srs_path(POWERS, TAU) != device_srs_path(POWERS + 1, TAU) != device_srs_path(POWERS, TAU + 1)


def _truncated(path, data):
    path.write_bytes(data[: len(data) // 2])


def _wrong_shape(path, data):
    bad = np.zeros((24, POWERS + 1), dtype=np.int32)
    np.savez(path, px=bad, py=bad, pz=bad, x2=np.zeros(288, dtype=np.uint8))


def _wrong_dtype(path, data):
    bad = np.zeros((24, POWERS), dtype=np.int64)
    np.savez(path, px=bad, py=bad, pz=bad, x2=np.zeros(288, dtype=np.uint8))


def _not_npz(path, data):
    path.write_bytes(b"not an npz file")


@pytest.mark.parametrize("spoil", [_truncated, _wrong_shape, _wrong_dtype, _not_npz],
                         ids=["truncated", "wrong_shape", "wrong_dtype", "not_npz"])
def test_bad_file_is_rebuilt(written, cache_dir, monkeypatch, spoil):
    """The SRS is computed anew (the kernel's plain version stands in by the
    points already computed) and the file rewritten to load."""
    setup, data = written
    path = cache_dir / os.path.basename(device_srs_path(POWERS, TAU))
    spoil(path, data)
    calls = []

    def computed(powers, tau, device):
        calls.append((powers, tau, str(device)))
        return setup.device_points["cpu"]

    monkeypatch.setattr(srs, "powers_of_tau_device", computed)
    rebuilt = Setup.generate_srs_device(POWERS, TAU, cache=True, device="cpu")
    assert calls == [(POWERS, TAU, "cpu")]
    assert all(torch.equal(g, w) for g, w in zip(rebuilt.device_points["cpu"], setup.device_points["cpu"]))
    pts, x_2 = setup_mod._load_device_srs(str(path), POWERS)
    assert all(np.array_equal(p, w.numpy()) for p, w in zip(pts, setup.device_points["cpu"])) and x_2 == setup.x_2
    assert os.listdir(cache_dir) == [path.name], "no temporary file is left"
    again = Setup.generate_srs_device(POWERS, TAU, cache=True, device="cpu")
    assert len(calls) == 1 and again.x_2 == setup.x_2


def test_no_cache_writes_nothing(written, cache_dir, monkeypatch):
    setup, _ = written
    monkeypatch.setattr(srs, "powers_of_tau_device", lambda powers, tau, device: setup.device_points["cpu"])
    Setup.generate_srs_device(POWERS, TAU, cache=False, device="cpu")
    assert os.listdir(cache_dir) == []


def test_cuda_without_a_card_raises(cache_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Setup.generate_srs_device(POWERS, TAU, cache=True)
    assert os.listdir(cache_dir) == []
