"""metacache_tpu_torch's dense_decode (its plain version on the CPU) and
probe_rows through it, against metacache_tpu's probe_rows (XLA ops on
the CPU, MC_PROBE_PALLAS=0) from the same feature rows, bit for bit
(tolerance 0, integer outputs). One case a row layout (u32 dense packed
slots, plain and pair-packed; u32 dense and two-tier (tgt, win) lanes;
u64 dense and two-tier packed slots), output encoding (a stored pk to
its own width, to another width and to (tgt, win); stored lanes to
(tgt, win) and packed), alternating runs off and on, and f = 1 or 16
features a read; the rows and probes of test_torch_cuda.dense_case
(misses, the sentinel, count 0, count = c and past it, row and
overflow indices past their tables)."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.ops import rows as jrows
from metacache_tpu_torch.ops import probe_decode as D
from metacache_tpu_torch.ops import rows as trows
from test_torch_cuda import (dense_case, dense_feats, dense_pack_cases,
                             dense_tables)

torch.set_num_threads(2)


def _jax_tag(d):
    """metacache_tpu's layout tag of a dense_case."""
    sb, hsl = d["sb"], d["hsl"]
    if hsl:
        return ("u64_two_tier" if d["wide"] else "two_tier", hsl,
                d["paired"], False, sb)
    if not sb:
        return "packed" if d["paired"] else True
    return f"{'u64' if d['wide'] else ''}pk{sb}{'p' if d['paired'] else ''}"


def _jax_probe(d, alt_runs, pack_bits):
    rows = d["rows"].reshape(-1, 128) if d["paired"] else d["rows"]
    ovf = np.zeros((1, 1), np.int32) if d["ovf"] is None else d["ovf"]
    uniq = np.zeros(d["rows"].shape[0], d["feats"].dtype)
    # JAX's 64-bit types are on only inside this block
    with jax.enable_x64(True) if d["wide"] else contextlib.nullcontext():
        return [np.asarray(x) for x in jrows.probe_rows(
            jnp.asarray(d["feats"]), jnp.asarray(uniq), None,
            jnp.asarray(rows), jnp.asarray(ovf), d["c"], dense=_jax_tag(d),
            alt_runs=alt_runs, pack_bits=pack_bits,
            idx_pre=jnp.asarray(d["idx"]))]


@pytest.mark.parametrize("f", [1, 16])
@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("layout,pack_bits", dense_pack_cases())
def test_dense_decode_matches_jax_probe_rows(layout, pack_bits, alt, f,
                                             monkeypatch):
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    d = dense_case(layout, f)
    c, hsl = d["c"], d["hsl"]
    alt_runs = d["alt"] if alt else 0
    rl, fr = (alt_runs, f) if alt else (c, 1)
    want = _jax_probe(d, alt_runs, pack_bits)
    t = dense_tables(d, "cpu")
    idx = torch.from_numpy(d["idx"])
    plain = D.dense_decode_plain(
        t.fused_rows, t.ovf_rows if hsl else None, idx,
        dense_feats(d, "cpu").reshape(-1), hsl, c, rl, fr, d["sb"],
        pack_bits)
    got = trows.probe_rows(dense_feats(d, "cpu"), t, alt_runs=alt_runs,
                           pack_bits=pack_bits, idx_pre=idx)
    b = d["feats"].shape[0]
    plain = [x.reshape(b, -1) for x in plain]
    if pack_bits:
        plain = plain * 2
    for w, p, g in zip(want, plain, got):
        w = np.asarray(w)
        assert w.shape == (b, f * rl)
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), w)
    # the case reaches what it claims to: hits, misses and, with two
    # tiers, slots read from overflow rows
    w = np.asarray(want[0]).reshape(-1, rl)
    kept = (w != 2**31 - 1).sum(axis=1)
    assert (kept == 0).any() and (kept == c).any()
    if hsl:
        assert (kept > hsl).any()


@pytest.mark.parametrize("bad", ["narrow_rows", "rl_below_c", "narrow_ovf",
                                 "hsl_past_c", "float_flat", "idx_length"])
def test_dense_decode_checks_shapes(bad):
    """The wrapper refuses what the kernel could not read in bounds."""
    d = dense_case("lanes_two_tier", 1)
    t = dense_tables(d, "cpu")
    args = dict(rows=t.fused_rows, ovf=t.ovf_rows,
                idx=torch.from_numpy(d["idx"]),
                flat=dense_feats(d, "cpu").reshape(-1), hsl=d["hsl"],
                c=d["c"], rl=d["c"], f=1, slot_bits=0, pack_bits=0)
    D.dense_decode(**args)
    args.update({
        "narrow_rows": dict(rows=t.fused_rows[:, :2 + 2 * d["hsl"]]),
        "rl_below_c": dict(rl=d["c"] - 1),
        "narrow_ovf": dict(ovf=t.ovf_rows[:, :d["c"]]),
        "hsl_past_c": dict(hsl=d["c"] + 1),
        "float_flat": dict(flat=args["flat"].float()),
        "idx_length": dict(idx=args["idx"][1:]),
    }[bad])
    with pytest.raises(ValueError):
        D.dense_decode(**args)
