"""The port's last API remainders against amg_tpu's: ``ops.spmv.spmv_n``,
``ops.blas`` (``dot``, ``norm2``, ``norminf``, ``axpy``, ``axpby``) and
the ``AMG_SETUP_TIMERS=1`` lines of the device pack and the setup.

The products and BLAS-1 mirror ``tests/test_sparse.py:56-65, 275-289``
(f64, rtol 1e-12 against numpy/scipy and amg_tpu); the timer lines must
carry amg_tpu's labels in amg_tpu's order.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amg_tpu as jamg
from amg_tpu.ops import blas as jblas, spmv as jspmv
from amg_tpu.sparse import CSR as JCSR, Ell as JEll

import amg_tpu_torch as tamg
from amg_tpu_torch.ops import blas as tblas, spmv as tspmv
from amg_tpu_torch.sparse import CSR as TCSR, Dia as TDia, Ell as TEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("fmt", ["ell", "dia"])
def test_spmv_n_matches_amg_tpu(rng, fmt):
    """``spmv_n``: the product cut to the logical rows (37 of a padded
    operator), as amg_tpu's on Ell; on a Dia operator against scipy."""
    s = sp.random(37, 41 if fmt == "ell" else 37, density=0.2,
                  random_state=np.random.RandomState(5), format="csr")
    s = s + sp.eye(*s.shape, format="csr")
    x = rng.standard_normal(s.shape[1])
    if fmt == "ell":
        ta = TEll.from_csr(TCSR.from_scipy(s), dtype=torch.float64)
        want = np.asarray(jspmv.spmv_n(JEll.from_csr(JCSR.from_scipy(s)), x))
        np.testing.assert_allclose(want, s @ x, rtol=1e-12)
    else:
        ta = TDia.from_csr(TCSR.from_scipy(s), dtype=torch.float64,
                           pad_rows_to=64)
        want = s @ x
        x = np.concatenate([x, np.zeros(64 - 37)])
    assert ta.padded_rows > 37
    got = tspmv.spmv_n(ta, torch.from_numpy(x)).numpy()
    assert got.shape == (37,)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_blas1_matches_amg_tpu(rng):
    """BLAS-1 (reference SSS_blas_array_*, amg/SSS_utils.c:151-260), the
    port's against numpy and amg_tpu's on the same vectors."""
    import jax.numpy as jnp

    x, y = rng.standard_normal(97), rng.standard_normal(97)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for name, args, want in (
            ("dot", (tx, ty), x @ y),
            ("norm2", (tx,), np.linalg.norm(x)),
            ("norminf", (tx,), np.abs(x).max()),
            ("axpy", (0.7, tx, ty), 0.7 * x + y),
            ("axpby", (0.3, tx, -1.2, ty), 0.3 * x - 1.2 * y)):
        got = getattr(tblas, name)(*args).numpy()
        jargs = tuple(jx if a is tx else jy if a is ty else a for a in args)
        ref = np.asarray(getattr(jblas, name)(*jargs))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(got, ref, rtol=1e-12)


def _timer_lines(text):
    """The timer lines of a setup's output, numbers replaced by ``#``."""
    return [re.sub(r"\d+\.\d+", "#", ln) for ln in text.splitlines()
            if re.match(r"(  pack |setup phases:)", ln)]


def test_setup_timers_match_amg_tpu(monkeypatch, capsys):
    """``AMG_SETUP_TIMERS=1``: the same labels, in the same order, as
    amg_tpu's (per-level pack and coarse-inverse lines on stderr, the
    "setup phases" line through ``log``); without the variable no such
    line, and the hierarchy is the same."""
    pars = dict(verbose=0)
    monkeypatch.setenv("AMG_SETUP_TIMERS", "1")
    jamg.AMGSolver(jamg.poisson2d(16), jamg.AMGParams(**pars), log=print)
    cj = capsys.readouterr()
    st = tamg.AMGSolver(tamg.poisson2d(16), tamg.AMGParams(**pars),
                        log=print, device="cpu")
    ct = capsys.readouterr()
    want_err, want_out = _timer_lines(cj.err), _timer_lines(cj.out)
    assert want_err == [f"  pack level {l}: #s" for l in range(3)] \
        + ["  pack coarse inverse: #s"]
    assert want_out == ["setup phases: host #s, plan #s, reorder #s, "
                        "pack #s"]
    assert _timer_lines(ct.err) == want_err
    assert _timer_lines(ct.out) == want_out

    monkeypatch.delenv("AMG_SETUP_TIMERS")
    s2 = tamg.AMGSolver(tamg.poisson2d(16), tamg.AMGParams(**pars),
                        log=print, device="cpu")
    c2 = capsys.readouterr()
    assert _timer_lines(c2.err) == _timer_lines(c2.out) == []
    for l1, l2 in zip(st.mg.levels, s2.mg.levels):
        assert torch.equal(l1.a.vals, l2.a.vals)
    assert torch.equal(st.mg.coarse_inv, s2.mg.coarse_inv)
