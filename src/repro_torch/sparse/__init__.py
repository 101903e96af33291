"""Static-capacity CSR, ELL and BSR over torch tensors, the numpy-seeded
generators and the numpy SpGEMM oracles."""
from repro_torch.sparse.formats import BSR, CSR, ELL, csr_row_ids, csr_to_ell, ell_to_csr
from repro_torch.sparse.generators import (
    aggregation_prolongator,
    banded_csr,
    galerkin_triple,
    random_csr,
    rmat_csr,
    stencil2d_csr,
)
from repro_torch.sparse.oracle import (
    dense_spgemm_oracle,
    gustavson_ell_structure,
    gustavson_numpy,
)

__all__ = [
    "CSR",
    "ELL",
    "BSR",
    "csr_row_ids",
    "csr_to_ell",
    "ell_to_csr",
    "random_csr",
    "rmat_csr",
    "banded_csr",
    "stencil2d_csr",
    "aggregation_prolongator",
    "galerkin_triple",
    "dense_spgemm_oracle",
    "gustavson_ell_structure",
    "gustavson_numpy",
]
