"""Static-capacity CSR over torch tensors and the numpy-seeded generators."""
from repro_torch.sparse.formats import CSR, csr_row_ids
from repro_torch.sparse.generators import (
    aggregation_prolongator,
    banded_csr,
    galerkin_triple,
    random_csr,
    rmat_csr,
    stencil2d_csr,
)

__all__ = [
    "CSR",
    "csr_row_ids",
    "random_csr",
    "rmat_csr",
    "banded_csr",
    "stencil2d_csr",
    "aggregation_prolongator",
    "galerkin_triple",
]
