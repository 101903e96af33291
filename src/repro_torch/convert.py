"""Carry the reference's state across: numpy arrays in, port objects out.

Callers hand over the JAX objects' arrays as numpy arrays (``np.asarray``
on the JAX side), so this module needs nothing of JAX. A plan built by the
reference replays in the port, and a port plan handed back through
``plan_to_numpy`` replays in the reference. ELL arrays cross as they are;
a bitmask crosses bit for bit between the reference's uint32 and the port's
int32 (``bitmask_from_numpy``, ``bitmask_to_numpy``). A BSR operand
crosses as a port ``BSR`` (``bsr_from_numpy``) and the block plan of
``kernels.bsr_spgemm`` as its five int32 arrays (``bsr_plan_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spgemm import SpgemmPlan
from repro_torch.sparse.formats import BSR, CSR, ELL

_PLAN_FIELDS = ("indptr", "indices", "seg_ids", "a_slot_s", "b_slot_s")


def tensor_from_numpy(x, device="cuda") -> torch.Tensor:
    """numpy -> tensor on ``device``. bfloat16 arrays (``ml_dtypes``, as JAX
    returns them) are carried bit for bit through a uint16 view."""
    x = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host. bfloat16 becomes float32 (exactly),
    since numpy has no bfloat16 of its own."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def csr_from_numpy(indptr, indices, values, shape, device="cuda") -> CSR:
    """A port CSR from a reference CSR's arrays (int32 indices)."""
    return CSR(indptr=tensor_from_numpy(np.asarray(indptr, np.int32), device),
               indices=tensor_from_numpy(np.asarray(indices, np.int32), device),
               values=tensor_from_numpy(values, device),
               shape=(int(shape[0]), int(shape[1])))


def plan_from_numpy(indptr, indices, seg_ids, a_slot_s, b_slot_s, shape,
                    device="cuda") -> SpgemmPlan:
    """A port SpgemmPlan from a reference plan's five int32 arrays."""
    arrays = [tensor_from_numpy(np.asarray(x, np.int32), device)
              for x in (indptr, indices, seg_ids, a_slot_s, b_slot_s)]
    return SpgemmPlan(*arrays, shape=(int(shape[0]), int(shape[1])))


def csr_to_numpy(c: CSR) -> dict:
    """A port CSR as numpy arrays: indptr, indices, values, shape."""
    return {"indptr": tensor_to_numpy(c.indptr),
            "indices": tensor_to_numpy(c.indices),
            "values": tensor_to_numpy(c.values), "shape": tuple(c.shape)}


def plan_to_numpy(plan: SpgemmPlan) -> dict:
    """A port plan as numpy arrays, keyed by the reference's field names."""
    out = {name: tensor_to_numpy(getattr(plan, name)) for name in _PLAN_FIELDS}
    out["shape"] = tuple(plan.shape)
    return out


def ell_from_numpy(indices, values, row_nnz, shape, device="cuda") -> ELL:
    """A port ELL from a reference ELL's arrays (int32 indices and widths)."""
    return ELL(indices=tensor_from_numpy(np.asarray(indices, np.int32), device),
               values=tensor_from_numpy(values, device),
               row_nnz=tensor_from_numpy(np.asarray(row_nnz, np.int32), device),
               shape=(int(shape[0]), int(shape[1])))


def ell_to_numpy(e: ELL) -> dict:
    """A port ELL as numpy arrays: indices, values, row_nnz, shape."""
    return {"indices": tensor_to_numpy(e.indices), "values": tensor_to_numpy(e.values),
            "row_nnz": tensor_to_numpy(e.row_nnz), "shape": tuple(e.shape)}


def bitmask_from_numpy(words, device="cuda") -> torch.Tensor:
    """A reference bitmask (uint32 words) as the port's int32 tensor with
    the same bits."""
    return tensor_from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32), device)


def bitmask_to_numpy(words: torch.Tensor) -> np.ndarray:
    """A port bitmask (int32 words) as the reference's uint32 words."""
    return np.ascontiguousarray(tensor_to_numpy(words)).view(np.uint32)


def bsr_from_numpy(indptr, indices, blocks, shape=None, device="cuda") -> BSR:
    """A reference BSR operand's arrays as a port ``BSR`` on ``device``:
    int32 structure and (nnzb, bm, bn) blocks. ``shape`` defaults to the
    smallest that holds every live block; the result still unpacks as
    ``(indptr, indices, blocks)``."""
    indptr = np.asarray(indptr, np.int32)
    indices = np.asarray(indices, np.int32)
    bm, bn = np.shape(blocks)[1:]
    if shape is None:
        live = indices[:int(indptr[-1])]
        shape = ((len(indptr) - 1) * bm, (int(live.max()) + 1 if live.size else 0) * bn)
    return BSR(indptr=tensor_from_numpy(indptr, device),
               indices=tensor_from_numpy(indices, device),
               blocks=tensor_from_numpy(blocks, device),
               shape=(int(shape[0]), int(shape[1])), block_shape=(int(bm), int(bn)))


def bsr_plan_from_numpy(c_indptr, c_indices, contrib_a, contrib_b, contrib_n,
                        device="cuda") -> tuple:
    """The five int32 arrays of the reference's ``plan_bsr_numeric`` as
    tensors on ``device``, in the same order."""
    return tuple(tensor_from_numpy(np.asarray(x, np.int32), device)
                 for x in (c_indptr, c_indices, contrib_a, contrib_b, contrib_n))
