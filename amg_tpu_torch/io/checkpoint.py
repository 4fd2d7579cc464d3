"""Hierarchy checkpoint / resume.

The reference has no state serialization (SURVEY.md section 5,
"Checkpoint / resume: None").  For production use the setup phase can be
expensive (host graph algorithms), so this module saves a built
:class:`~amg_tpu_torch.hierarchy.HostHierarchy` to a single ``.npz`` file and
restores it without re-running coarsening/interpolation — the device pack
(:func:`amg_tpu_torch.hierarchy.to_device`) is cheap and redone at load.
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSR
from ..hierarchy import HostHierarchy

_FORMAT_VERSION = 3


def _put_csr(out: dict, key: str, m: CSR) -> None:
    out[f"{key}_indptr"] = np.asarray(m.indptr, dtype=np.int64)
    out[f"{key}_indices"] = np.asarray(m.indices, dtype=np.int32)
    out[f"{key}_data"] = np.asarray(m.data, dtype=np.float64)
    out[f"{key}_shape"] = np.asarray(m.shape, dtype=np.int64)


def _get_csr(z, key: str) -> CSR:
    return CSR(
        z[f"{key}_indptr"],
        z[f"{key}_indices"],
        z[f"{key}_data"],
        tuple(int(v) for v in z[f"{key}_shape"]),
    )


def save_hierarchy(path, hh: HostHierarchy, compress: bool = True) -> None:
    """Serialize a host hierarchy to ``path`` (.npz).

    ``compress=False`` trades ~3x file size for ~8x faster save/load —
    the right choice for scratch caches (a 10M-row hierarchy compresses
    for minutes)."""
    out: dict = {
        "version": np.asarray(_FORMAT_VERSION),
        "num_levels": np.asarray(hh.num_levels),
        "num_cfmarks": np.asarray(len(hh.cfmark)),
        "setup_seconds": np.asarray(hh.setup_seconds),
    }
    for l, m in enumerate(hh.a):
        _put_csr(out, f"a{l}", m)
    for l, m in enumerate(hh.p):
        _put_csr(out, f"p{l}", m)
    for l, m in enumerate(hh.r):
        _put_csr(out, f"r{l}", m)
    for l, cf in enumerate(hh.cfmark):
        # aggregation (SA) levels carry no C/F marks; a zero-length array
        # is the None sentinel (real marks always have one entry per row)
        out[f"cfmark{l}"] = (
            np.asarray(cf, dtype=np.int64) if cf is not None
            else np.zeros(0, dtype=np.int64)
        )
    if hh.gs_key is not None:
        for l, key in enumerate(hh.gs_key):
            if key is not None:
                out[f"gs_key{l}"] = np.asarray(key, dtype=np.int64)
    # v3: reorder_for_gs metadata, so a restored hierarchy skips the
    # (expensive) re-permutation pass entirely — the matrices are saved
    # already-permuted, and perms/banded_nb/formats are what downstream
    # packing (fine-grid embedding, each level's format) consumes
    if hh.perms is not None:
        out["has_reorder"] = np.asarray(1)
        for l, p in enumerate(hh.perms):
            if p is not None:
                out[f"perm{l}"] = np.asarray(p, dtype=np.int64)
    if hh.banded_nb is not None:
        for l, nb in enumerate(hh.banded_nb):
            if nb is not None:
                out[f"banded_nb{l}"] = np.asarray(nb, dtype=np.int64)
    if hh.formats is not None:
        for l, fmt in enumerate(hh.formats):
            out[f"format{l}"] = np.asarray(fmt)
    (np.savez_compressed if compress else np.savez)(path, **out)


def load_hierarchy(path) -> HostHierarchy:
    """Restore a host hierarchy saved by :func:`save_hierarchy`."""
    z = np.load(path)
    version = int(z["version"])
    if version not in (1, 2, _FORMAT_VERSION):
        raise ValueError(f"unsupported hierarchy checkpoint version {version}")
    nl = int(z["num_levels"])
    ncf = int(z["num_cfmarks"])
    gs_key = None
    if version >= 2:
        gs_key = [
            z[f"gs_key{l}"] if f"gs_key{l}" in z.files else None
            for l in range(nl)
        ]
    perms = banded_nb = formats = None
    if version >= 3:
        if "has_reorder" in z.files:
            perms = [
                z[f"perm{l}"] if f"perm{l}" in z.files else None
                for l in range(nl)
            ]
            banded_nb = [
                int(z[f"banded_nb{l}"]) if f"banded_nb{l}" in z.files
                else None
                for l in range(nl)
            ]
            # none in a checkpoint written before the formats were kept:
            # its levels pack as they did (hierarchy.level_formats)
            if "format0" in z.files:
                formats = [str(z[f"format{l}"]) for l in range(nl)]
    return HostHierarchy(
        a=[_get_csr(z, f"a{l}") for l in range(nl)],
        p=[_get_csr(z, f"p{l}") for l in range(nl - 1)],
        r=[_get_csr(z, f"r{l}") for l in range(nl - 1)],
        cfmark=[
            z[f"cfmark{l}"] if len(z[f"cfmark{l}"]) else None
            for l in range(ncf)
        ],
        setup_seconds=float(z["setup_seconds"]),
        gs_key=gs_key,
        perms=perms,
        banded_nb=banded_nb,
        formats=formats,
    )
