from .matrix_market import read_mtx, write_mtx
from .generators import poisson2d, poisson3d, random_spd
from .checkpoint import save_hierarchy, load_hierarchy

__all__ = [
    "read_mtx", "write_mtx", "poisson2d", "poisson3d", "random_spd",
    "save_hierarchy", "load_hierarchy",
]
