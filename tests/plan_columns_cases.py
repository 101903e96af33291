"""The cases on which ``kernels.plan_columns`` is held against its plain
version. ``tests/test_torch_plan_columns.py`` and phase 2b of
``chip_smoke.py`` both use this one list."""
import torch


def plan_columns_cases(dev="cuda", rmat_scale=15, grid=2048, log=lambda msg: None):
    """(case, heads, seg_ids, cols_s, nnz_cap, timed), one expansion held at a
    time. The sorted expansions of RMAT graph 0's A*A (rmat_csr(rmat_scale,
    16, seed 0): the benchmark's graph 0 before its labels are permuted) and
    of the multigrid A*P (galerkin_triple(grid, grid, 4)), each at nnz_cap =
    nnz, at the pow2 bucket above it (a zero tail; the timed case at RMAT)
    and at nnz // 2 (ids past the end dropped), and as views at offsets 1-3
    (misaligned for the 16-byte loads); then A times an all-zero B (fm 0:
    padding only, no head). Each expansion is the fresh path's:
    ``expand_and_sort`` at the capacity that ``prepare_sparse_inputs`` gives
    it."""
    from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity
    from repro_torch.core.spgemm import expand_and_sort, prepare_sparse_inputs
    from repro_torch.sparse import CSR, galerkin_triple, rmat_csr

    def operands():
        rm = rmat_csr(rmat_scale, 16, seed=0, device=dev)
        yield "RMAT graph 0 A*A", rm, rm
        _, a, p = galerkin_triple(grid, grid, agg_size=4, device=dev)
        yield "multigrid A*P", a, p
        n = rm.shape[1]
        zero = CSR(indptr=torch.zeros(n + 1, dtype=torch.int32, device=dev),
                   indices=torch.zeros(8, dtype=torch.int32, device=dev),
                   values=torch.zeros(8, device=dev), shape=(n, 7))
        yield "A times zero", rm, zero

    for name, a, b in operands():
        a, b, _, _, fm_cap = prepare_sparse_inputs(a, b, DEFAULT_PAD_POLICY)
        sx = expand_and_sort(a, b, fm_cap)
        nnz = int(sx.row_sizes.sum())
        arrays = (sx.heads, sx.seg_ids, sx.cols_s)
        del sx
        log(f"   {name}: {arrays[0].shape[0]} slots, nnz(C) {nnz}")
        bucket = round_capacity(nnz, "pow2")
        for cap in sorted({nnz, bucket, nnz // 2}):
            yield (f"{name}, nnz_cap {cap}", *arrays, cap,
                   name.startswith("RMAT") and cap == bucket)
        for off in (1, 2, 3):
            yield f"{name}, views at +{off}", *(t[off:] for t in arrays), bucket, False
        del arrays
