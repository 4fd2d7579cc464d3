"""Loaded by pytest before any module of ``benchmark/tests``.

``benchmark/tests/conftest.py``'s ``small_data`` shrinks every configuration of
``BENCHMARK.json`` by its row of ``SMALL``, which has none for the ring's
configuration, and the benchmark's existing files are not edited: the
ring's test size is registered here, so that every test module, run
alone or together, finds it.
"""

from benchmark.tests import conftest as _tests

_tests.SMALL.setdefault("p3d7_4x1m", ({"nx": 12, "ny": 12, "nz": 24}, 200))
