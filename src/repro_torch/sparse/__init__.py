"""Static-capacity CSR and ELL over torch tensors and the numpy-seeded generators."""
from repro_torch.sparse.formats import CSR, ELL, csr_row_ids, csr_to_ell, ell_to_csr
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
    "ELL",
    "csr_row_ids",
    "csr_to_ell",
    "ell_to_csr",
    "random_csr",
    "rmat_csr",
    "banded_csr",
    "stencil2d_csr",
    "aggregation_prolongator",
    "galerkin_triple",
]
