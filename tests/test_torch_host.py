"""The port's jax-free host layer against amg_tpu's.

amg_tpu_torch carries its own copy of the numpy setup code (importing any
amg_tpu module would import jax) and builds amg_tpu's native C++ source
into its own library.  Same code, same library: the host hierarchies must
be identical, bit for bit, and so must the device packs built from them.
Both packages get the same explicit format flags (use_well="off",
use_banded="off", embed_levels=0): amg_tpu resolves "auto" from JAX's
device count (off under the tests' 8 virtual devices), the port as on one
device (on).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.io import checkpoint as jck

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch import native as tnative
from amg_tpu_torch.io import checkpoint as tck

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(__file__), "data")
FLAGS = dict(use_well="off", use_banded="off", embed_levels=0, verbose=0)
SLICE = dict(dtype="float32", refine=True, smoother="GS",
             coarse_smoother="CHEBYSHEV", coarse_op_dtype="bfloat16",
             coarse_sparsify=0.005, sparsify_from_level=2)
# the unstructured slice (WEll levels, FCG) at test size: well_min_rows
# and the Dense budget lowered so that fem2d(5000)'s top levels are WEll
WELL = dict(dtype="float32", refine=True, accel="cg", smoother="GS",
            coarse_smoother="CHEBYSHEV", coarse_op_dtype="float32",
            coarse_sparsify=0, use_well="on", well_min_rows=1024,
            dense_level_bytes=2e7)


def _matrix(name):
    """(amg_tpu CSR, amg_tpu_torch CSR) of the same matrix."""
    if name == "1138_bus":
        path = os.path.join(DATA, "1138_bus.mtx")
        return jamg.read_mtx(path), tamg.read_mtx(path)
    if name == "p3d16":
        return jamg.poisson3d(16), tamg.poisson3d(16)
    if name == "p2d48aniso":
        return (jamg.poisson2d(48, epsilon=1e-3),
                tamg.poisson2d(48, epsilon=1e-3))
    if name == "fem2d":
        return jamg.fem2d(5000, seed=9), tamg.fem2d(5000, seed=9)
    raise KeyError(name)


def _pars(pkg, **kw):
    """AMGParams of one package, enums given by name."""
    kw = {**FLAGS, **kw}
    for key, enum in (("smoother", pkg.SmootherType),
                      ("coarse_smoother", pkg.SmootherType),
                      ("interp_type", pkg.InterpType),
                      ("cs_type", pkg.CoarsenType)):
        if key in kw:
            kw[key] = enum[kw[key]]
    return pkg.AMGParams(**kw)


def _host_pair(name, **kw):
    aj, at = _matrix(name)
    pj, pt = _pars(jamg, **kw), _pars(tamg, **kw)
    hj = jh.reorder_for_gs(jh.setup_host(aj, pj), pj)
    ht = th.reorder_for_gs(th.setup_host(at, pt), pt)
    return hj, ht, pj, pt


def _assert_csr_equal(mj, mt, what):
    assert mj.shape == mt.shape, what
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(mj, field), getattr(mt, field),
                                      err_msg=f"{what}.{field}")


def _assert_host_equal(hj, ht):
    assert hj.num_levels == ht.num_levels
    for name in ("a", "p", "r"):
        assert len(getattr(hj, name)) == len(getattr(ht, name))
        for l, (mj, mt) in enumerate(zip(getattr(hj, name),
                                         getattr(ht, name))):
            _assert_csr_equal(mj, mt, f"{name}[{l}]")
    assert len(hj.cfmark) == len(ht.cfmark)
    for l, (cj, ct) in enumerate(zip(hj.cfmark, ht.cfmark)):
        if cj is None:
            assert ct is None
        else:
            np.testing.assert_array_equal(cj, ct, err_msg=f"cfmark[{l}]")
    for name in ("gs_key", "perms"):
        for l, (vj, vt) in enumerate(zip(getattr(hj, name),
                                         getattr(ht, name))):
            if vj is None:
                assert vt is None, f"{name}[{l}]"
            else:
                np.testing.assert_array_equal(vj, vt,
                                              err_msg=f"{name}[{l}]")


HOST_CASES = [
    ("1138_bus", dict(interp_type="DIR")),
    ("1138_bus", dict(interp_type="STD")),
    ("p3d16", dict(interp_type="DIR")),
    ("p3d16", dict(interp_type="STD")),
    ("p2d48aniso", dict(interp_type="DIR")),
    ("p2d48aniso", dict(interp_type="STD")),
    ("p3d16", dict(cs_type="PMIS")),
    ("p3d16", dict(cs_type="SA")),
    ("p3d16", SLICE),
    ("fem2d", WELL),
    ("fem2d", dict(WELL, coarse_smoother="GS")),
]


def test_native_library_built():
    """The port builds its own copy of the C++ source into its own
    directory."""
    assert tnative.lib is not None
    assert os.path.dirname(tnative._SO).endswith(
        os.path.join("amg_tpu_torch", "build"))
    assert tnative._SRC.endswith(os.path.join("amg_tpu_torch", "native",
                                              "amg_native.cpp"))


def test_native_source_copy_identical():
    """The port's copy of the setup C++ is byte for byte amg_tpu's."""
    from amg_tpu import native as jnative

    with open(jnative._SRC, "rb") as f:
        want = f.read()
    with open(tnative._SRC, "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize(
    "name,kw", HOST_CASES,
    ids=[f"{n}-{'-'.join(f'{v}' for v in kw.values())}"[:60]
         for n, kw in HOST_CASES])
def test_host_hierarchy_identical(name, kw):
    hj, ht, _, _ = _host_pair(name, **kw)
    assert ht.num_levels >= 3
    _assert_host_equal(hj, ht)


@pytest.mark.parametrize("name,kw", [("p3d16", dict(interp_type="STD")),
                                     ("fem2d", WELL)],
                         ids=["p3d16-STD", "fem2d-well"])
def test_checkpoint_carry_over(tmp_path, name, kw):
    """amg_tpu.save_hierarchy -> port load_hierarchy gives identical
    arrays (format v3, reorder metadata included: the level-0 RCM
    permutation of a WEll level 0 too), and the loaded hierarchy packs
    as amg_tpu packs its own."""
    hj, _, pj, pt = _host_pair(name, **kw)
    path = tmp_path / "hh.npz"
    jck.save_hierarchy(path, hj)
    ht = tck.load_hierarchy(path)
    _assert_host_equal(hj, ht)
    assert ht.setup_seconds == hj.setup_seconds
    mj = jh.to_device(hj, pj)
    mt = th.to_device(ht, pt, device="cpu")
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        for op in ("a", "p", "r"):
            if getattr(lj, op) is not None:
                _assert_op_equal(getattr(lj, op), getattr(lt, op),
                                 f"{op}[{l}]")
    # and back: the port writes what amg_tpu reads
    path2 = tmp_path / "hh2.npz"
    tck.save_hierarchy(path2, ht)
    _assert_host_equal(jck.load_hierarchy(path2), ht)


def _np(t):
    return t.cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()


def _assert_op_equal(oj, ot, what):
    """One packed operator (A, P or R) of both packages, field by field."""
    kind = type(oj).__name__
    assert kind == type(ot).__name__, what
    bf16 = oj.vals.dtype == jnp.bfloat16
    assert (ot.vals.dtype == torch.bfloat16) == bf16, what
    _assert_dev_equal(oj.vals, ot.vals, f"{what}.vals", bf16)
    if kind == "Dia":
        assert tuple(oj.offsets) == ot.offsets, what
    if kind == "Ell":
        _assert_dev_equal(oj.cols, ot.cols, f"{what}.cols")
    if kind == "WEll":
        assert (oj.shape, oj.nnz, oj.pad_cols) == \
            (ot.shape, ot.nnz, ot.pad_cols), what
        _assert_dev_equal(oj.loc, ot.loc, f"{what}.loc")
        _assert_dev_equal(oj.base, ot.base, f"{what}.base")
        assert (oj.vals_lo is None) == (ot.vals_lo is None), what
        if oj.vals_lo is not None:
            _assert_dev_equal(oj.vals_lo, ot.vals_lo, f"{what}.vals_lo")


def _assert_dev_equal(xj, xt, what, bf16=False):
    xj = np.asarray(xj.astype(np.float32) if bf16 else xj)
    xt = _np(xt)
    assert xj.shape == xt.shape, what
    # bf16 too: amg_tpu rounds f64 -> bf16 directly, the port through f32;
    # a double-rounding difference would fail here
    np.testing.assert_array_equal(xt, xj, err_msg=what)


PACK_CASES = [
    ("1138_bus", {}),
    ("p3d16", {}),
    ("p3d16", SLICE),
    ("fem2d", WELL),
    ("fem2d", dict(WELL, transfer_op_dtype="bfloat16")),
]


@pytest.mark.parametrize("name,kw", PACK_CASES,
                         ids=["1138_bus", "p3d16", "p3d16-slice",
                              "fem2d-well", "fem2d-well-bf16-transfer"])
def test_device_pack_matches(name, kw):
    """Port ``to_device`` against amg_tpu's: same formats, pads, operator
    values, transfer operators, diagonals, GS groups and coarse inverse
    (and, with WEll levels, the same level-0 RCM permutation)."""
    hj, ht, pj, pt = _host_pair(name, **kw)
    if kw.get("use_well") == "on":
        assert ht.perms[0] is not None
    mj = jh.to_device(hj, pj)
    mt = th.to_device(ht, pt, device="cpu")
    assert mj.num_levels == mt.num_levels
    kinds = set()
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        kinds.add(type(lt.a).__name__)
        assert lj.pad == lt.pad
        _assert_op_equal(lj.a, lt.a, f"a[{l}]")
        if type(lj.a).__name__ == "Ell":
            _assert_dev_equal(lj.diag_mask, lt.diag_mask, f"diag_mask[{l}]")
        for op in ("p", "r"):
            oj, ot = getattr(lj, op), getattr(lt, op)
            assert (oj is None) == (ot is None)
            if oj is not None:
                _assert_op_equal(oj, ot, f"{op}[{l}]")
        for v in ("diag", "inv_diag", "l1_inv", "gid", "gs_w"):
            vj, vt = getattr(lj, v), getattr(lt, v)
            assert (vj is None) == (vt is None), f"{v}[{l}]"
            if vj is not None:
                _assert_dev_equal(vj, vt, f"{v}[{l}]")
        assert lj.group_cf == lt.group_cf
        assert lj.ranges == lt.ranges
        assert float(lj.rho_dinv_a) == lt.rho_dinv_a
        if lj.groups is not None:
            gj = np.asarray(lj.groups)
            for g, idx in enumerate(lt.groups):
                np.testing.assert_array_equal(
                    gj[g][gj[g] < lj.pad], idx.numpy())
    _assert_dev_equal(mj.coarse_inv, mt.coarse_inv, "coarse_inv")
    if kw.get("use_well") == "on":
        assert "WEll" in kinds and isinstance(mt.levels[0].p, tamg.WEll)


def test_restored_hierarchy_gets_level0_rcm():
    """A restored hierarchy whose coarse levels were reordered but whose
    level 0 was not (perms[0] None) gets level 0's RCM pass in ``setup``
    when level 0 is headed for WEll, as in amg_tpu."""
    aj, at = _matrix("fem2d")
    pj, pt = _pars(jamg, **WELL), _pars(tamg, **WELL)
    off_j, off_t = pj.replace(use_well="off"), pt.replace(use_well="off")
    hj = jh.reorder_for_gs(jh.setup_host(aj, off_j), off_j)
    ht = th.reorder_for_gs(th.setup_host(at, off_t), off_t)
    assert ht.perms[0] is None
    mj, _ = jh.setup(aj, pj, hh=hj, log=lambda *_: None)
    mt, _ = th.setup(at, pt, hh=ht, log=lambda *_: None, device="cpu")
    assert ht.perms[0] is not None
    np.testing.assert_array_equal(ht.perms[0], hj.perms[0])
    _assert_op_equal(mj.levels[0].a, mt.levels[0].a, "a[0]")


def test_unported_options_raise():
    """A bf16 cycle is not ported and raises; BandedBlocks, fine-grid
    embedding and the multi-device layouts (pads that split into
    ``dist_devices`` shards) are ported and set up."""
    a = tamg.poisson3d(6)
    with pytest.raises(NotImplementedError):
        tamg.setup(a, tamg.AMGParams(verbose=0, dtype="bfloat16"),
                   device="cpu")
    for kw in (dict(use_banded="on"), dict(embed_levels=2),
               dict(dist_devices=2)):
        mg, _ = tamg.setup(a, tamg.AMGParams(verbose=0, **kw), device="cpu",
                           log=lambda *_: None)
        if "dist_devices" in kw:
            assert all(lv.pad % 2 == 0 for lv in mg.levels)
