"""The port's ring of row shards against amg_tpu's multi-device layer.

Setup with ``dist_devices = D``: the host hierarchy and the device packs
equal amg_tpu's for D = 4 and 8 (pads that split into D shards, the
embedded Dia operators, the WEll packs and their ring plans).  The ring
Dia product (``parallel.spmv_dia_ring``) against amg_tpu's on its 8
virtual devices and against the port's single-device product, in f64 at
rtol 1e-13 (the diagonals of a row are summed in offsets order in every
version).  B1's window entry in its plain version (``spmv_window_plain``)
against the single-device plain product of the global operator (equal:
the same sums in the same order), and against amg_tpu's Pallas
``spmv_window`` run in interpret mode, at the tolerances of
tests/test_torch_dia.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.ops import pallas_dia
from amg_tpu.parallel import make_mesh as jmake_mesh
from amg_tpu.parallel.halo import spmv_dia_ring as jspmv_dia_ring
from amg_tpu.sparse import Dia as JDia

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import dia_kernel as K
from amg_tpu_torch.parallel import (make_mesh, shard_hierarchy,
                                    shard_vector, spmv_dia_ring)
from amg_tpu_torch.parallel import dist as tdist, halo as thalo
from amg_tpu_torch.sparse import Dia

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")


def _np(t):
    return t.cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()


def _jnp(v):
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_make_mesh_on_cpu():
    """Shards, processes and device of a one-process mesh; a count that
    the processes cannot split raises; the card is the default and raises
    without one."""
    mesh = make_mesh(4, device="cpu")
    assert (mesh.n_shards, mesh.local, mesh.first, mesh.world) == (4, 4, 0, 1)
    assert mesh.describe() == "mesh: 4 shards, 1 process, cpu"
    assert make_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(4)
    # psum: per-shard partials summed over the shards
    t = torch.arange(8, dtype=torch.float64).reshape(4, 2)
    np.testing.assert_array_equal(mesh.psum(t).numpy(), [12.0, 16.0])


def test_shard_vector_and_hierarchy_views():
    """A row-sharded vector is the process's (S, m) block; one process
    holding every shard keeps views of the packed tensors (no copy)."""
    mesh = make_mesh(4, device="cpu")
    v = shard_vector(np.arange(10.0), mesh, pad_to=16)
    assert v.shape == (4, 4)
    np.testing.assert_array_equal(v.reshape(-1).numpy()[:10], np.arange(10.0))
    assert not v.reshape(-1)[10:].any()
    a = tamg.poisson3d(8)
    pars = tamg.AMGParams(verbose=0, embed_levels=8, dist_devices=4)
    mg, _ = th.setup(a, pars, **QUIET, **CPU)
    smg = shard_hierarchy(mg, mesh, pars, replicate_from_level=1)
    l0, s0 = mg.levels[0], smg.levels[0]
    assert s0.a.vals.data_ptr() == l0.a.vals.data_ptr()
    assert s0.diag.shape == (4, l0.pad // 4)
    assert s0.diag.data_ptr() == l0.diag.data_ptr()
    assert s0.gs_w is None and smg.levels[1] is mg.levels[1]


# ---------------------------------------------------------------------------
# host setup with D shards
# ---------------------------------------------------------------------------


SETUP_CASES = {
    "p3d16-embedded": (lambda p: p.poisson3d(16), dict(embed_levels=8)),
    "fem2d-well": (lambda p: p.fem2d(20000, seed=3),
                   dict(use_well="on", well_min_rows=4096,
                        dense_level_bytes=2e7, dtype="float32",
                        coarse_op_dtype="bfloat16")),
}


def _assert_op_equal(oj, ot, what):
    assert type(oj).__name__ == type(ot).__name__, what
    assert (ot.vals.dtype == torch.bfloat16) == (oj.vals.dtype
                                                 == jnp.bfloat16), what
    np.testing.assert_array_equal(_np(ot.vals), _jnp(oj.vals), err_msg=what)
    kind = type(ot).__name__
    if kind == "Dia":
        assert tuple(oj.offsets) == ot.offsets, what
    if kind == "Ell":
        np.testing.assert_array_equal(ot.cols.numpy(), np.asarray(oj.cols))
    if kind == "WEll":
        np.testing.assert_array_equal(ot.loc.numpy(), np.asarray(oj.loc))
        np.testing.assert_array_equal(ot.base.numpy(), np.asarray(oj.base))
        assert ot.pad_cols == oj.pad_cols, what
        assert ot.ring_plan == oj.ring_plan, what
        assert ot.ring_plan is not None, what


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("name", list(SETUP_CASES))
def test_setup_with_shards_matches_amg_tpu(name, D):
    """``dist_devices = D``: the same host hierarchy, level pads that
    split into D shards (amg_tpu/hierarchy.py:1319-1347), formats,
    embedded offsets and values, and WEll packs with their ring plans.
    amg_tpu's "auto" is "on" here (``dist_devices > 1``): the port gets
    "on" for BandedBlocks, as its own "auto" keeps fewer bands."""
    mk, kw = SETUP_CASES[name]
    pj = jamg.AMGParams(verbose=0, dist_devices=D, **kw)
    pt = tamg.AMGParams(verbose=0, dist_devices=D, use_banded="on", **kw)
    mj, hj = jh.setup(mk(jamg), pj, **QUIET)
    mt, ht = th.setup(mk(tamg), pt, **QUIET, **CPU)
    assert hj.num_levels == ht.num_levels
    for l in range(hj.num_levels):
        np.testing.assert_array_equal(ht.a[l].data, hj.a[l].data)
    assert [l.pad for l in mt.levels] == [l.pad for l in mj.levels]
    assert all(l.pad % D == 0 for l in mt.levels)
    wells = 0
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        for op in ("a", "p", "r"):
            oj, ot = getattr(lj, op), getattr(lt, op)
            assert (oj is None) == (ot is None), f"{op}[{l}]"
            if oj is not None:
                _assert_op_equal(oj, ot, f"{op}[{l}]")
                wells += type(ot).__name__ == "WEll"
        for v in ("diag", "inv_diag", "gid"):
            vj, vt = getattr(lj, v), getattr(lt, v)
            assert (vj is None) == (vt is None), f"{v}[{l}]"
            if vj is not None:
                np.testing.assert_array_equal(_np(vt), _jnp(vj))
        if lt.compact_idx is not None:
            cj = np.asarray(lj.compact_idx)
            np.testing.assert_array_equal(lt.compact_idx.numpy(),
                                          cj[: lt.compact_idx.shape[0]])
    if name == "fem2d-well":
        assert wells >= 3      # level 0's A, P and R at least
    else:
        E = th.embedding_plan(ht, pt)[0]
        assert E >= 1 and all(mt.levels[l].pad == mt.levels[0].pad
                              for l in range(E + 1))


# ---------------------------------------------------------------------------
# ring product
# ---------------------------------------------------------------------------


RING_CASES = {
    "p3d8": (lambda p: p.poisson3d(8), 5),    # offsets up to +/-64
    "p2d4-multihop": (lambda p: p.poisson2d(4), 1),  # blocks of 2, band 4
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_product_matches_amg_tpu(name):
    """``spmv_dia_ring`` on 8 shards against amg_tpu's ring product on its
    8 virtual devices and against the port's single-device product:
    multi-hop halos where the band is wider than a shard, zeros (no
    wrap-around) at the mesh edges."""
    mk, seed = RING_CASES[name]
    aj, at = mk(jamg), mk(tamg)
    pad = -(-at.n_rows // 64) * 64 if at.n_rows > 64 else 16
    x = np.pad(np.random.default_rng(seed).standard_normal(at.n_rows),
               (0, pad - at.n_rows))
    jd = JDia.from_csr(aj, dtype=jnp.float64, pad_rows_to=pad)
    want = np.asarray(jspmv_dia_ring(jd, jnp.asarray(x), jmake_mesh(8)))
    d = Dia.from_csr(at, dtype=torch.float64, pad_rows_to=pad)
    thalo.counts.update(products=0, halo_bytes=0)
    y = spmv_dia_ring(d, torch.from_numpy(x), make_mesh(8, device="cpu"))
    assert y.shape == (8, pad // 8)
    np.testing.assert_allclose(y.reshape(-1).numpy(), want, rtol=1e-13,
                               atol=1e-14)
    single = K.spmv(d, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y.reshape(-1).numpy(), single, rtol=1e-13,
                               atol=1e-14)
    # halo entries taken from other shards: lo + hi per shard, less what
    # falls off the mesh's two edges
    lo, hi = thalo.dia_halo_widths(d.offsets)
    m = pad // 8
    want_n = sum(min(lo, s * m) + min(hi, (7 - s) * m) for s in range(8))
    assert thalo.counts["products"] == 1
    assert thalo.counts["halo_bytes"] == want_n * 8


def test_psum_counts_and_all_gather_in_one_process():
    mesh = make_mesh(2, device="cpu")
    tdist.counts.update(psum=0, all_gather=0)
    x = torch.ones(2, 3)
    assert mesh.psum(x.sum(-1)).item() == 6.0
    assert mesh.all_gather(x) is x
    assert tdist.counts == {"psum": 1, "all_gather": 1}


# ---------------------------------------------------------------------------
# B1's window entry: the plain version
# ---------------------------------------------------------------------------


def _random_dia(nd, pad, vdt, seed):
    rng = np.random.default_rng(seed)
    offs = sorted({0, *rng.choice(np.arange(-300, 301), size=nd - 1,
                                  replace=False).tolist()})
    while len(offs) < nd:
        offs = sorted(set(offs) | {int(rng.integers(-300, 301))})
    vals = torch.from_numpy(rng.standard_normal((nd, pad))).to(vdt)
    return Dia(vals, tuple(offs), (pad, pad), nd * pad)


def _windows(x, S, lo, hi):
    """(S, lo + m + hi) haloed windows of a global x, zeros off the ends."""
    m = x.shape[0] // S
    xp = torch.nn.functional.pad(x, (lo, hi))
    return torch.stack([xp[s * m: s * m + lo + m + hi] for s in range(S)])


DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.float32),
          "f64": (torch.float64, torch.float64)}


@pytest.mark.parametrize("nd", [7, 19, 40])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("S", [1, 4])
def test_window_plain_matches_global_product(S, dt, nd):
    """``spmv_window_plain`` on S shards equals the single-device plain
    product of the global operator, bit for bit (bf16 products on 40
    diagonals included); wider windows than the band change nothing, and
    the values may be a view with another row stride."""
    vdt, xdt = DTYPES[dt]
    pad = 4096
    d = _random_dia(nd, pad, vdt, seed=nd)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(pad)) \
        .to(xdt)
    want = K.spmv_plain(d, x)
    lo, hi = thalo.dia_halo_widths(d.offsets)
    for extra in (0, 5):
        got = K.spmv_window_plain(d, _windows(x, S, lo + extra, hi + extra),
                                  lo + extra)
        assert got.shape == (S, pad // S)
        assert torch.equal(got.reshape(-1), want)
    # the shards' values as a column slice of a wider tensor
    wide = torch.cat([d.vals, d.vals], dim=1)
    dv = Dia(wide[:, :pad], d.offsets, d.shape, d.nnz)
    assert dv.vals.stride(0) == 2 * pad
    assert torch.equal(K.spmv_window_plain(dv, _windows(x, S, lo, hi), lo)
                       .reshape(-1), want)
    # the entry dispatches CPU tensors to the plain version
    assert torch.equal(K.spmv_window(d, _windows(x, S, lo, hi), lo)
                       .reshape(-1), want)


@pytest.mark.parametrize("dt,tol", [("f32", 2e-6), ("bf16", 1e-5)])
@pytest.mark.parametrize("nd", [7, 40])
def test_window_plain_matches_pallas_interpret(dt, tol, nd):
    """One shard's window of real halo data (not zeros) through
    ``spmv_window_plain`` and amg_tpu's ``pallas_dia.spmv_window`` in
    interpret mode, to tests/test_torch_dia.py's tolerances of max|Ax|."""
    vdt, xdt = DTYPES[dt]
    m = pallas_dia.TILE
    d = _random_dia(nd, m, vdt, seed=3 + nd)
    lo, hi = thalo.dia_halo_widths(d.offsets)
    xw = torch.from_numpy(np.random.default_rng(4).standard_normal(
        lo + m + hi)).to(xdt)
    got = K.spmv_window_plain(d, xw[None], lo)[0].numpy()
    jv = jnp.asarray(_np(d.vals)).astype(
        jnp.bfloat16 if vdt == torch.bfloat16 else jnp.float32)
    jd = JDia(jv, d.offsets, (m, m), nd * m)
    want = np.asarray(pallas_dia.spmv_window(jd, jnp.asarray(xw.numpy()),
                                             interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale


def test_window_entry_rejects_what_the_kernel_does_not_take():
    d = _random_dia(7, 64, torch.float32, seed=0)
    lo, hi = thalo.dia_halo_widths(d.offsets)
    x = torch.zeros(64)
    with pytest.raises(ValueError):          # 3 shards do not split 64
        K.spmv_window(d, _windows(torch.zeros(63), 3, lo, hi), lo)
    with pytest.raises(ValueError):          # window too short
        K.spmv_window(d, torch.zeros(1, 10), lo)
    with pytest.raises(TypeError):
        K.spmv_window(d, _windows(x.double(), 2, lo, hi), lo)


def test_cli_under_torchrun():
    """``torchrun`` with 2 processes of 2 shards (gloo on the CPU): every
    process runs the same solve loop (their host decisions agree), only
    rank 0 prints, and the table equals the one-process run's (but for
    the timing lines)."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    flags = ["-m", "amg_tpu_torch", "poisson3d:12", "--devices", "4",
             "--device", "cpu"]
    multi = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port", str(port),
         *flags], cwd=repo, env=env, capture_output=True, text=True,
        timeout=240)
    one = subprocess.run([sys.executable, *flags], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=240)
    assert multi.returncode == 0, multi.stderr
    assert one.returncode == 0, one.stderr
    skip = ("AMG setup time", "AMG solve time", "mesh: ")
    got = [ln for ln in multi.stdout.splitlines() if not ln.startswith(skip)]
    want = [ln for ln in one.stdout.splitlines() if not ln.startswith(skip)]
    assert got == want
    assert sum(ln.startswith("AMG iterations") for ln in got) == 1
    assert "mesh: 4 shards, 2 processes, cpu" in multi.stdout
