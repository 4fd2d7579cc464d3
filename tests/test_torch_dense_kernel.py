"""The port's Dense kernel wrapper (amg_tpu_torch.ops.dense_kernel, D1: a
bf16 Dense operator times one f32 vector) on the CPU, and the dispatch
that routes products to it.

On the CPU the wrapper runs its plain version, which is the product the
port computed before D1: the values widened to f32, then one matmul.  It
is held to that bit for bit, and to ``amg_tpu``'s ``spmv_dense`` (XLA's
convert + dot of the same bf16 values) within the f32 summation bound:
two sums of the same n products in f32, in any two orders, differ by at
most ``2 * n * 2**-24 * sum_j |a_ij x_j|``.

The CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amg_tpu.ops.spmv import spmv_dense as jax_spmv_dense
from amg_tpu.sparse import Dense as JDense

import amg_tpu_torch as tamg
from amg_tpu_torch.ops import dense_kernel, spmv as tspmv
from amg_tpu_torch.solve import smoothers
from amg_tpu_torch.sparse import Dense

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (rows, cols, pad_rows_to, pad_cols_to): a square operator padded as a
# level is (rows to 8, columns to 128), and one padded to a wider level
# pad, as hierarchy.py packs a Dense level (pad_cols_to = the level pad)
SHAPES = {"square": (300, 300, None, None),
          "pad_cols_to": (300, 300, 1024, 1024),
          "ragged": (37, 45, None, None)}


def _dense(shape, dtype=torch.bfloat16, seed=0):
    n, m, pr, pc = SHAPES[shape]
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, m)) * (rng.random((n, m)) < 0.3)
    rr, cc = np.nonzero(dense)
    csr = tamg.CSR.from_coo(rr, cc, dense[rr, cc], (n, m))
    a = Dense.from_csr(csr, dtype=dtype, pad_rows_to=pr, pad_cols_to=pc)
    x = torch.from_numpy(rng.standard_normal(a.padded_cols + 5)).float()
    return a, x


def _widened(a, x, start=0, size=None):
    """The port's product before D1 (spmv_dense, _range_update_dense_)."""
    end = a.padded_rows if size is None else start + size
    return a.vals[start:end].to(x.dtype) @ x[: a.padded_cols]


@pytest.mark.parametrize("rows", ["all", "range"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_is_the_widened_product(shape, rows):
    """On CPU tensors the wrapper is spmv_plain, and both equal the
    widen-then-matmul product bit for bit, over all rows and a row range;
    spmv_dense gives the same bits through the dispatch."""
    a, x = _dense(shape)
    kw = {} if rows == "all" else dict(start=8, size=a.padded_rows // 2 - 3)
    want = _widened(a, x, **kw)
    assert torch.equal(dense_kernel.spmv(a, x, **kw), want)
    assert torch.equal(dense_kernel.spmv_plain(a, x, **kw), want)
    if rows == "all":
        assert torch.equal(tspmv.spmv_dense(a, x), want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_amg_tpu(shape):
    """The plain version against amg_tpu's spmv_dense on the same bf16
    values and f32 x (XLA on the CPU), within the f32 summation bound."""
    a, x = _dense(shape, seed=1)
    got = dense_kernel.spmv(a, x).numpy()
    v = a.vals.float().numpy()
    ja = JDense(jnp.asarray(v).astype(jnp.bfloat16), a.shape, a.nnz)
    want = np.asarray(jax_spmv_dense(ja, jnp.asarray(x.numpy())))
    xs = x[: a.padded_cols].numpy()
    bound = 2 * a.padded_cols * 2.0 ** -24 * (np.abs(v) @ np.abs(xs))
    assert got.shape == want.shape == (a.padded_rows,)
    assert np.all(np.abs(got - want) <= bound)


# (values dtype, vector dtype, vector dims): only the first goes to D1
DISPATCH = [(torch.bfloat16, torch.float32, 1, True),
            (torch.bfloat16, torch.float32, 2, False),
            (torch.float32, torch.float32, 1, False),
            (torch.float32, torch.float32, 2, False),
            (torch.float64, torch.float64, 1, False),
            (torch.bfloat16, torch.float64, 1, False)]


@pytest.mark.parametrize("vdt,xdt,dims,to_d1", DISPATCH)
def test_dispatch_sends_only_bf16_by_f32_vectors(monkeypatch, vdt, xdt,
                                                 dims, to_d1):
    """spmv_dense and the Dense range GS update route a product to the
    kernel module only for bf16 values times one f32 vector; every other
    case keeps its matmul, and gives what it gave before."""
    a, x = _dense("square", dtype=vdt)
    x = x.to(xdt)
    if dims == 2:
        x = torch.stack([x, 2 * x])
    calls = []

    def record(a, x, start=0, size=None):
        calls.append((start, size))
        return dense_kernel.spmv_plain(a, x, start, size)

    monkeypatch.setattr(dense_kernel, "spmv", record)
    y = tspmv.spmv_dense(a, x)
    v = a.vals.to(xdt)
    want = x[..., : a.padded_cols] @ v.T if dims == 2 \
        else v @ x[: a.padded_cols]
    assert torch.equal(y, want)
    assert calls == ([(0, None)] if to_d1 else [])

    # the range update of a GS class on a Dense level
    n = a.padded_rows
    level = type("Level", (), {})()
    level.a = a
    level.diag = torch.linspace(1.0, 2.0, n, dtype=xdt)
    level.inv_diag = 1.0 / level.diag
    b = torch.ones(x.shape, dtype=xdt)
    got = x.clone()
    calls.clear()
    smoothers._range_update_dense_(level, got, b, 16, 40)
    sub = a.vals[16:56].to(xdt)
    ax = x[..., : a.padded_cols] @ sub.T if dims == 2 \
        else sub @ x[: a.padded_cols]
    old = x[..., 16:56]
    want = x.clone()
    want[..., 16:56] = (b[..., 16:56] - ax + level.diag[16:56] * old) \
        * level.inv_diag[16:56]
    assert torch.equal(got, want)
    assert calls == ([(16, 40)] if to_d1 else [])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Wrong dtypes, a batch, a short x and rows outside the operator
    raise; a call on CPU tensors counts no launch."""
    a, x = _dense("square")
    with pytest.raises(TypeError):
        dense_kernel.spmv(a, x.double())
    with pytest.raises(TypeError):
        dense_kernel.spmv(a, torch.stack([x, x]))
    with pytest.raises(TypeError):
        dense_kernel.spmv(Dense(a.vals.float(), a.shape, a.nnz), x)
    with pytest.raises(ValueError):
        dense_kernel.spmv(a, x[: a.padded_cols - 8])
    with pytest.raises(ValueError):
        dense_kernel.spmv(a, x, start=a.padded_rows - 4, size=8)
    counts = dict(dense_kernel.launches)
    by_shape = dict(dense_kernel.launches_by_shape)
    dense_kernel.spmv(a, x)
    assert dense_kernel.launches == counts
    assert dense_kernel.launches_by_shape == by_shape
