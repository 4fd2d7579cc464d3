"""Seconds of the host set-up of the hierarchy (coarsening,
interpolation, Galerkin products), as the program times it."""


def read(rec):
    return rec["hierarchy_s"]
