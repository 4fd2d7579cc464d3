"""Seconds from the start of the process to the start of the window:
imports, CUDA start-up, the matrix, the AMG set-up, graph capture and
warm-up (the first run in a checkout also builds the kernels)."""


def read(rec):
    return rec["setup_s"]
