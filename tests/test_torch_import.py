"""metacache_tpu_torch imports and runs with JAX and metacache_tpu
unavailable: the GPU host has no JAX, and the port keeps its own copy of
the host code it needs, so no module of the port may reach either."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "metacache_tpu_torch")
DATA = os.path.join(REPO, "tests", "data")

_BLOCKED = (
    "import sys, runpy, pkgutil, importlib\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['metacache_tpu'] = None\n"
    "sys.argv = ['metacache_tpu_torch'] + sys.argv[1:]\n")
_CLI = "runpy.run_module('metacache_tpu_torch', run_name='__main__')"


def _run(code, *args):
    env = dict(os.environ, MC_TORCH_DEVICE="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.run([sys.executable, "-c", _BLOCKED + code, *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def test_every_module_imports_without_jax():
    names = [m.name for m in pkgutil.walk_packages(
        [PKG], prefix="metacache_tpu_torch.")
        if m.name != "metacache_tpu_torch.__main__"]
    code = ("import metacache_tpu_torch\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print('ok', len(sys.modules))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("args", [["help"], ["help", "query"], ["info"]])
def test_cli_runs_without_jax(args):
    r = _run(_CLI, *args)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip()


def _strip(text):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    return [l for l in text.splitlines() if not any(d in l for d in drop)]


def test_build_query_info_without_jax_or_metacache_tpu(tmp_path):
    """The port's build, query and info on the fixture, in processes where
    both packages are blocked; the query output equals the golden."""
    db = str(tmp_path / "db")
    r = _run(_CLI, "build", db, f"{DATA}/genomes.fa", "-taxonomy",
             f"{DATA}/taxonomy")
    assert r.returncode == 0, r.stderr[-2000:]
    r = _run(_CLI, "query", db, f"{DATA}/reads_single.fa")
    assert r.returncode == 0, r.stderr[-2000:]
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        assert _strip(r.stdout) == _strip(f.read())
    r = _run(_CLI, "info", db)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "kmer size          16" in r.stdout


def test_long_window_modes_without_jax_or_metacache_tpu(tmp_path):
    """`build -winlen 255` of the first three fixture genomes, `modify`
    with the rest, and `build+query` of all of them, in processes where
    both packages are blocked: the modified database answers the query
    as build+query does."""
    recs = open(os.path.join(DATA, "genomes.fa")).read().split(">")[1:]
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    a.write_text("".join(">" + r for r in recs[:3]))
    b.write_text("".join(">" + r for r in recs[3:]))
    db = str(tmp_path / "db")
    tax = ["-taxonomy", f"{DATA}/taxonomy"]
    reads = f"{DATA}/reads_single.fa"
    for args in (["build", db, str(a), "-winlen", "255"] + tax,
                 ["modify", db, str(b)] + tax):
        r = _run(_CLI, *args)
        assert r.returncode == 0, r.stderr[-2000:]
    q = _run(_CLI, "query", db, reads)
    bq = _run(_CLI, "build+query", f"{DATA}/genomes.fa", "-winlen", "255",
              *tax, "-query", reads)
    assert q.returncode == 0 and bq.returncode == 0, bq.stderr[-2000:]
    lines = [l for l in _strip(q.stdout) if not l.startswith("#")]
    assert len(lines) > 100
    assert lines == [l for l in _strip(bq.stdout) if not l.startswith("#")]


def test_device_builder_runs_without_jax():
    """ops/table_device.py imports, builds and exports a table and stages
    it again as classed cells, in a process where JAX and metacache_tpu
    are blocked."""
    code = (
        "import os, numpy as np, torch\n"
        "from metacache_tpu_torch.ops import table_device as T\n"
        "rng = np.random.default_rng(1)\n"
        "pool = rng.integers(0, 2**32, 700, dtype=np.int64)\n"
        "f = torch.from_numpy(pool[rng.integers(0, 700, 5000)]"
        ".astype(np.uint32).view(np.int32))\n"
        "t = torch.arange(5000, dtype=torch.int32) // 100\n"
        "w = torch.arange(5000, dtype=torch.int32) % 100\n"
        "dt = T.build_device_table(f, t, w)\n"
        "u, o, l = T.export_csr(dt)\n"
        "os.environ['MC_CLASSED'] = '1'\n"
        "st = T.device_layout_from_csr(u, o, (l >> np.uint64(32))"
        ".astype(np.uint32), (l & np.uint64(0xFFFFFFFF)).astype(np.uint32),"
        " device=torch.device('cpu'), budget_bytes=2 << 20,"
        " allow_dense=False)\n"
        "assert dt.dense and st.classed and st.nf == dt.nf == len(u)\n"
        "print('ok', sys.modules['jax'] is None)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["ok", "True"]


def test_no_jax_import_in_the_port():
    """Neither JAX nor metacache_tpu, in the port or in chip_smoke.py."""
    pat = re.compile(
        r"^\s*(import jax|from jax)\b|"
        r"^\s*(import|from)\s+metacache_tpu(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def _reads_of(reader):
    """-> (codes per read, headers, packed 2-bit codes per read) of the
    first 4096 records; buffer bytes past each read are not data."""
    codes, lens, hdrs = reader.read_batch_raw(4096)
    return ([c[:n].tolist() for c, n in zip(codes, lens)],
            [h.tobytes().split(b"\0")[0] for h in hdrs])


def _packed_of(reader):
    packed, plens, scodes, slens, shdrs, used = \
        reader.read_batch_packed(4096, 127)
    bases = ((packed[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3) \
        .reshape(len(packed), -1)
    return ([b[:n].tolist() for b, n in zip(bases, plens)],
            [c[:n].tolist() for c, n in zip(scodes, slens)],
            [h.tobytes().split(b"\0")[0] for h in shdrs], used)


def test_native_reader_matches_metacache_tpu():
    """The port's native reader, built from its own sources, parses the
    fixture's reads into the codes and headers of metacache_tpu.native."""
    from metacache_tpu import native as ref
    from metacache_tpu_torch import native as ours
    assert ours.get_lib() is not None
    assert os.path.dirname(ours.library_path()).endswith(
        os.path.join("build", "metacache_tpu_torch"))
    for name in ("reads_single.fa", "reads_single.fq"):
        path = os.path.join(DATA, name)
        assert ours.scan_file(path) == ref.scan_file(path)
        for read in (_reads_of, _packed_of):
            a = ours.NativeFastxReader(path, max_len=1024)
            b = ref.NativeFastxReader(path, max_len=1024)
            got, want = read(a), read(b)
            a.close(), b.close()
            assert len(got[0]) > 0
            assert got == want


def test_kernel_binds_its_entry_point_once(monkeypatch):
    """A kernel wrapper loads the library and looks its C entry point up
    at its first launch only; later launches take neither the library
    lock nor the lookup, pass the current stream last and count once
    each. A non-zero CUDA error raises and does not count."""
    from metacache_tpu_torch import kernels

    class Lib:
        lookups = 0
        calls = []

        def __getattr__(self, name):
            Lib.lookups += 1
            if name != "mc_test":
                raise AttributeError(name)
            return lambda *a: Lib.calls.append(a) or (7 if a[0] < 0 else 0)

        def mc_error_string(self, err):
            return b"test error"

    loads = []
    monkeypatch.setattr(kernels, "_load",
                        lambda: loads.append(1) or Lib())
    monkeypatch.setattr(kernels, "_lib", Lib())
    monkeypatch.setattr(kernels, "_stream_getter", lambda: lambda: 99)
    k = kernels.Kernel("mc_test", "x.py:1", "y.cu")
    k(1, 2)
    k(3, 4)
    assert (len(loads), Lib.lookups, k.launches) == (1, 1, 2)
    assert Lib.calls == [(1, 2, 99), (3, 4, 99)]
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        k(-1)
    assert k.launches == 2 and len(loads) == 1
