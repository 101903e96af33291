"""The system under test as the harness drives it: the port ``repro_torch``.

The only places where the harness enters the program. A traffic mix names,
product by product, the options each call takes (``traffic/<mix>.json``),
so a mix that pins another backend, calls another entry of the port or
replays in batches is a data file:

* ``pin(a, b, options)``: ``ReuseExecutor.from_matrices(A, B, **options)``,
  a fresh multiply whose plan the executor keeps (``backend``,
  ``pad_policy``, ``tune``, ...);
* ``structure(handle)``: C's row pointers and column indices of that plan;
* ``replay(handle, a_values, b_values)``: ``ReuseExecutor.apply``, or
  ``apply_batched`` where either operand's values are stacked (2-D);
* ``fresh(a, b, call, options)``: the port's function ``call``
  ("module:name", e.g. "repro_torch.core.spgemm:spgemm") on (A, B) with
  ``options`` as keyword arguments; what a caller keeps of it: C (the
  result's ``c`` where it has one), a CSR or an ELL triple (row sizes,
  columns, values);
* ``csr(answer)``: such an answer as (indptr, indices, values), once the
  window has closed.

``release()`` drops what the program keeps between calls. A control or a
planted fault stands in for the program by giving these calls another body
(``control.py``, the tests).
"""
from __future__ import annotations

import importlib

import torch

PROGRAM = "repro_torch"


def resolve(call: str):
    """The port's function named "module:attribute.attribute"."""
    module, _, attr = call.partition(":")
    if module.split(".")[0] != PROGRAM or not attr:
        raise ValueError(f"{call!r} is not a function of {PROGRAM} ('module:name')")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


class PortSystem:
    def __init__(self):
        from repro_torch.core.executor import ReuseExecutor
        from repro_torch.core.plan_cache import default_plan_cache
        from repro_torch.obs import trace
        from repro_torch.sparse.formats import CSR

        self._executor, self._trace, self._csr = ReuseExecutor, trace, CSR
        self._cache = default_plan_cache()

    def _to_port(self, x):
        return self._csr(indptr=x.indptr, indices=x.indices, values=x.values,
                         shape=tuple(x.shape))

    def set_trace_mode(self, mode: str) -> None:
        """The program's span mode: "off", or "xprof", in which its spans
        are ``torch.profiler`` annotations."""
        self._trace.set_tracing(mode)

    def pin(self, a, b, options: dict):
        return self._executor.from_matrices(self._to_port(a), self._to_port(b), **options)

    def structure(self, handle):
        return handle.plan.indptr, handle.plan.indices

    def replay(self, handle, a_values, b_values):
        if a_values.dim() > 1 or b_values.dim() > 1:
            return handle.apply_batched(a_values, b_values)
        return handle.apply(a_values, b_values)

    def release(self) -> None:
        """Drop the plans the program keeps for itself (its default plan
        cache, which ``pin`` fills), so that the reference runs in the
        memory they held."""
        self._cache.clear()

    def fresh(self, a, b, call: str, options: dict):
        out = resolve(call)(self._to_port(a), self._to_port(b), **options)
        return getattr(out, "c", out)

    @staticmethod
    def csr(answer):
        if hasattr(answer, "indptr"):
            return answer.indptr, answer.indices, answer.values
        row_nnz, cols, vals = answer  # ELL: row sizes, (m, width) columns and values
        keep = torch.arange(cols.shape[1], device=cols.device) < row_nnz.long()[:, None]
        indptr = torch.zeros(row_nnz.shape[0] + 1, dtype=torch.int64, device=cols.device)
        indptr[1:] = torch.cumsum(row_nnz.long(), 0)
        return indptr, cols[keep], vals[keep]
