"""metacache_tpu_torch's grid of devices (parallel/mesh.py): the sharded
build sketch step against metacache_tpu's on its 8-device virtual CPU
mesh (tests/test_mesh.py:24-48), eight ``cpu`` entries standing for the
eight devices; inputs from numpy with a seed, tolerance 0."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.config import SketchingOptions
from metacache_tpu.parallel import mesh as JM
from metacache_tpu_torch.parallel import mesh as M

OPT = SketchingOptions().resolved()
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _windows(n, seed=5):
    rng = np.random.default_rng(seed)
    wins = np.full((n, OPT.winlen), 4, np.uint8)
    wins[:, :100] = rng.integers(0, 4, (n, 100), dtype=np.uint8)
    valid = np.full(n, 100, np.int32)
    tgt = np.repeat(np.arange(n // 8, dtype=np.int32), 8)
    wid = np.tile(np.arange(8, dtype=np.int32), n // 8)
    return wins, valid, tgt, wid


@pytest.mark.parametrize("num_data,num_table", [(4, 2), (8, 1)])
def test_sharded_build_step_equals_jax(num_data, num_table):
    """Every position sketches its slice; the triples come back in
    window order, equal to JAX's sharded step's."""
    wins, valid, tgt, wid = _windows(64)
    grid = M.make_mesh(num_data, num_table, CPU8)
    f, t, w = M.sharded_build_step(
        torch.from_numpy(wins), torch.from_numpy(valid),
        torch.from_numpy(tgt), torch.from_numpy(wid), grid, k=16,
        sketchlen=16)
    jf, jt, jw = JM.sharded_build_step(
        jnp.asarray(wins), jnp.asarray(valid), jnp.asarray(tgt),
        jnp.asarray(wid), JM.make_mesh(num_data, num_table), k=16,
        sketchlen=16)
    np.testing.assert_array_equal(f.numpy().view(np.uint32), np.asarray(jf))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_sharded_build_step_refuses_an_uneven_split():
    wins, valid, tgt, wid = _windows(64)
    with pytest.raises(ValueError, match="do not split"):
        M.sharded_build_step(
            torch.from_numpy(wins[:60]), torch.from_numpy(valid[:60]),
            torch.from_numpy(tgt[:60]), torch.from_numpy(wid[:60]),
            M.make_mesh(8, 1, CPU8), k=16, sketchlen=16)


def test_make_mesh_rows_and_defaults(monkeypatch):
    """make_mesh fills the grid row by row, as JAX's reshapes
    jax.devices() (mesh.py:31-38), and needs enough devices; the default
    devices are the CPU alone under MC_TORCH_DEVICE=cpu."""
    devs = [torch.device("cpu")] * 6
    grid = M.make_mesh(2, 3, devs)
    assert grid.shape == (2, 3) and all(d.type == "cpu" for d in grid.flat)
    with pytest.raises(ValueError, match="need 8 devices"):
        M.make_mesh(4, 2, devs)
    assert M.default_devices() == [torch.device("cpu")]
    assert M.make_mesh(1, 1).shape == (1, 1)
    assert M.distinct(grid) == [torch.device("cpu")]
    monkeypatch.delenv("MC_TORCH_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MC_TORCH_DEVICE=cpu"):
            M.default_devices()
