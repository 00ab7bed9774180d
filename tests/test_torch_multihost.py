"""metacache_tpu_torch's multi-process dryrun (parallel/multihost_dryrun
.py), the twin of tests/test_multihost.py: two processes joined by gloo,
two cpu devices each, run the sharded row step over their rows of one
global batch on their own (data, table) grid; each holds its rows
against the port's single-device step (tolerance 0) and prints
MULTIHOST_OK."""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(os.environ.get("MC_SKIP_MULTIHOST") == "1",
                    reason="multihost dryrun disabled")
@pytest.mark.parametrize("local_devices", [2, 4])
def test_two_process_cluster(local_devices):
    port = _free_port()
    env = dict(os.environ, MC_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metacache_tpu_torch.parallel.multihost_dryrun",
         "--coordinator", f"localhost:{port}", "--nprocs", "2", "--pid",
         str(pid), "--local-devices", str(local_devices)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"MULTIHOST_OK pid={pid} procs=2 devices={2 * local_devices}" \
            in out, out + err[-2000:]


def test_dryrun_refuses_without_a_device(monkeypatch):
    """No CUDA device and no MC_TORCH_DEVICE=cpu: the worker raises
    rather than run on the CPU."""
    from metacache_tpu_torch.parallel import multihost_dryrun as D
    import torch
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="MC_TORCH_DEVICE=cpu"):
        D._devices(2)


def test_single_process_helpers():
    """Without a process group: one process owns every row; the grid is
    the whole global grid."""
    import numpy as np
    import torch
    from metacache_tpu_torch.parallel import multihost as MH
    assert (MH.process_count(), MH.process_index()) == (1, 0)
    assert MH.process_row_range(10) == (0, 10)
    grid = MH.make_global_mesh(2, 2, [torch.device("cpu")] * 4)
    assert grid.shape == (2, 2)
    assert MH.global_batch(np.zeros((8, 3)), grid).shape == (8, 3)
    with pytest.raises(ValueError, match="do not split"):
        MH.global_batch(np.zeros((6, 3)), grid)
    assert MH.local_values([torch.arange(2), torch.arange(2, 4)]).tolist() \
        == [0, 1, 2, 3]
    assert MH.all_ok(True)
