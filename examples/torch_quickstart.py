"""Quickstart on the PyTorch port: the paper's SpGEMM as a library, end to end.

The port of examples/quickstart.py, scene for scene:
  1. two-phase SpGEMM (symbolic -> allocate -> numeric) on a multigrid
     triple product R*A*P, validated against the dense oracle;
  2. the Reuse case (new values, cached structure plan) against a fresh run;
  3. compression statistics (CF / CMRF and the 15% rule);
  4. the kernel-backed two-phase pipeline (kernels.ops.pallas_spgemm): on
     the card the CUDA kernel K5 sizes C's rows and K4 or K3 (the
     meta-algorithm's pick) fills its values; on the CPU their plain
     versions run.

On the card a fresh sparse multiply's numeric phase is the CUDA kernel K1.
Runs on the card by default; --device cpu runs it on the CPU:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import compress_matrix, compression_decision, numeric_reuse, spgemm
from repro_torch.kernels.ops import pallas_spgemm, resolve_numeric_kernel
from repro_torch.sparse import CSR, galerkin_triple


def pick_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The asked device; ``ap.error`` (exit 2) for a card that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is visible; pass --device cpu to run on the CPU")
    return device


def galerkin_products(device):
    """Scene 1: A*P on the sparse path (which returns a reuse plan), then
    R*(AP) by the meta-algorithm's method. Returns (r, a, p, ap, rap)."""
    r, a, p = galerkin_triple(32, 32, agg_size=4, device=device)
    ap = spgemm(a, p, method="sparse")
    rap = spgemm(r, ap.c)
    return r, a, p, ap, rap


def dense_rap(r: CSR, a: CSR, p: CSR) -> np.ndarray:
    """The dense oracle of R*A*P, in float32 numpy."""
    dense = [x.to_dense().cpu().numpy() for x in (r, a, p)]
    return dense[0] @ dense[1] @ dense[2]


def new_values(a: CSR) -> CSR:
    """A with fresh seeded values on its structure."""
    vals = np.random.default_rng(0).standard_normal(a.nnz_cap).astype(np.float32)
    return CSR(a.indptr, a.indices, torch.from_numpy(vals).to(a.device), a.shape)


def reuse_vs_fresh(a2: CSR, p: CSR, ap):
    """Scene 2: the numeric phase alone on the cached plan, and a fresh run.
    Returns (reused values, fresh result)."""
    return numeric_reuse(ap.plan, a2.values, p.values), spgemm(a2, p)


def compression(a: CSR):
    """Scene 3: (cf, cmrf, applied) of the bitmask compression on A*A."""
    return compression_decision(a, a, compress_matrix(a))


def kernel_pipeline(a: CSR, p: CSR):
    """Scene 4: (c_nnz, c_idx, c_val) of the kernel-backed pipeline, C in ELL
    layout, and the numeric kernel the meta-algorithm picks for it."""
    return pallas_spgemm(a, p), resolve_numeric_kernel(a, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = pick_device(ap, ap.parse_args(argv).device)

    # -- 1. two-phase SpGEMM on a Galerkin triple product ------------------
    r, a, p, ap_res, rap = galerkin_products(device)
    print(f"A: {a.shape} nnz={int(a.nnz())}   P: {p.shape} nnz={int(p.nnz())}")
    st = ap_res.stats
    print(f"A*P: nnz={st['nnz_c']}  method={st['method']}  cache={st['cache']}  "
          f"fm_cap={st['fm_cap']} (pad_policy={st['pad_policy']}); numeric phase "
          f"{st['replay_backend']}")
    np.testing.assert_allclose(rap.c.to_dense().cpu().numpy(), dense_rap(r, a, p),
                               rtol=1e-4, atol=1e-4)
    print("R*A*P validated against the dense oracle")

    # -- 2. Reuse: same structure, new values ------------------------------
    a2 = new_values(a)
    reused, fresh = reuse_vs_fresh(a2, p, ap_res)
    nnz = int(fresh.c.nnz())
    np.testing.assert_allclose(reused[:nnz].cpu().numpy(), fresh.c.values[:nnz].cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    print("Reuse path == fresh run (numeric phase only, no symbolic)")

    # -- 3. compression ----------------------------------------------------
    cf, cmrf, use = compression(a)
    print(f"compression on A*A: CF={cf:.2f} CMRF={cmrf:.2f} "
          f"applied={use} (rule: CF <= 0.85)")

    # -- 4. the kernel-backed pipeline (CUDA kernels on the card) -----------
    (c_nnz, c_idx, c_val), kernel = kernel_pipeline(a, p)
    n0 = int(c_nnz[0])
    np.testing.assert_allclose(c_val[0, :n0].cpu().numpy(),
                               ap_res.c.values[:n0].cpu().numpy(), rtol=1e-4, atol=1e-5)
    ran = "CUDA kernels K5 + " if device.type == "cuda" else "the plain versions of K5 + "
    print(f"kernels.ops.pallas_spgemm ({ran}{'K4' if kernel == 'dense_acc' else 'K3'}, "
          f"{kernel!r}) agrees with the sparse path")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
