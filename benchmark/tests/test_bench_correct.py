"""The comparison that decides ``correct``, shown to fail: the
lower-precision controls, and runs driven with the timed path broken
underneath (the harness's look for a card skipped; the CPU, test
sizes)."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import check

CELLS = ["p3d7_1m.solve", "fem2d_1m.fcg", "p3d7_1m.batch16"]


def _judge(with_batch, data, name, seed, params=None):
    cell = harness.Cell(with_batch, name, data)
    sess = harness.Session(cell, "cpu", params=params)
    rec = sess.drive(seed, 0.3, False, time.time())
    sess.close()
    inputs, sample, probe, y = rec.pop("_")
    rec["numbers"] = harness.numbers(sess.ref, inputs, sample, probe, y)
    return harness.result(cell, rec, False, {}), sess, (inputs, sample,
                                                          probe)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(with_batch, small_data, name):
    for seed in (2**32 + 1, 2**32 + 2):
        out, _, _ = _judge(with_batch, small_data, name, seed)
        assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["p3d7_1m.solve", "fem2d_1m.fcg"])
def test_the_float32_outer_loop_fails(with_batch, small_data, name):
    """The program with its float32 outer loop in place of float64 defect
    correction or FCG cannot reach 1e-8: not correct."""
    out, _, _ = _judge(with_batch, small_data, name, 7,
                       params={"refine": False})
    assert not out["correct"]
    assert out["checks"]["rres_worst"]["value"] > \
        out["checks"]["rres_worst"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_references_fail(with_batch, small_data, name):
    """The reference one precision below the program's, in its place:
    the level-0 product in bfloat16, and the residual the entry reports
    one step below its own, each read over its limit."""
    out, sess, (inputs, sample, probe) = _judge(with_batch, small_data,
                                                name, 11)
    limits = harness.Cell(with_batch, name, small_data).limits
    gap = check.product_gap(check.control_product(sess.ref, probe),
                            sess.ref.matvec(probe))
    assert gap > limits["l0_op_gap"]
    below = torch.bfloat16 if name.endswith("batch16") else torch.float32
    j, x, _ = sample[0]
    x = np.asarray(x, dtype=np.float64)
    low = check.control_residual(sess.ref, inputs[j], x, below)
    true = float(np.max(sess.ref.rel_residual(inputs[j], x)))
    assert abs(low - true) > limits["rres_report_gap"]


def _unchanged(mp):
    """A cycle that hands its iterate back unchanged."""
    import amg_tpu_torch.solve.driver as driver

    mp.setattr(driver, "cycle", lambda mg, x, b, pars: x)


def _altered(mp):
    """The solution altered where it is produced."""
    from amg_tpu_torch.solve.driver import AMGSolver

    unpad = AMGSolver._unpad_vec

    def altered(self, xd):
        x = unpad(self, xd).copy()
        x[0] += 1.0
        return x

    mp.setattr(AMGSolver, "_unpad_vec", altered)


def _half_batch(mp):
    """Half of the batch's columns left out of the answer."""
    from amg_tpu_torch.solve.driver import AMGSolver

    unpad = AMGSolver._unpad_vec

    def half(self, xd):
        x = unpad(self, xd).copy()
        if x.ndim == 2:
            x[:, x.shape[1] // 2:] = 0.0
        return x

    mp.setattr(AMGSolver, "_unpad_vec", half)


FAULTS = {"unchanged": _unchanged, "altered": _altered,
          "half_batch": _half_batch}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "half_batch" or c.endswith("batch16")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(with_batch, small_data,
                                            monkeypatch, name, fault):
    """A run driven through the harness with the program broken under it
    reports ``correct`` false.  (The exchange between cards has no fault
    here: every cell runs on one card.)"""
    FAULTS[fault](monkeypatch)
    cell = harness.Cell(with_batch, name, small_data)
    rec = harness.run(cell, 5, 0.3, False, "cpu", time.time())
    out = harness.result(cell, rec, False, {})
    assert out["correct"] is False, out["checks"]
