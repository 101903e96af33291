"""Logical sharding rules (port of ``repro/models/sharding.py``): the DP / TP /
EP / SP mapping of every tensor role.

Axis conventions, as in the reference:
  * batch  -> ('pod', 'data')   (pod acts as outer data parallelism)
  * TP     -> 'model' (attention heads + FFN columns + vocab, Megatron-style)
  * EP     -> 'model' (MoE experts)
  * SP     -> 'model' on the sequence dim of the residual stream (train), and
              on the KV-cache sequence dim for long-context decode.

A spec is a plain tuple of axis names (``None`` for a replicated dim, a
tuple of names for a dim split over several axes), entry for entry the
reference's ``PartitionSpec``.

Activations live on a data x model mesh as DTensors (``compat.DTensorMesh``;
params and inputs placed by ``models.place``). ``constraint`` redistributes a
DTensor to the spec's placements (``compat.spec_placements``), the port's
``with_sharding_constraint``: where GSPMD takes the constraint as a hint and
propagates, DTensor moves the data there and then. With ``enabled`` false
every hook returns its input; with it true a plain tensor raises
``SpgemmConfigError`` (nothing is left unplaced by accident). The model
paths run without implicit replication: a plain tensor that meets a
DTensor raises (DTensor's own check), and the constants they make from
shapes alone (positions, masks, zero accumulators) are placed as
replicated DTensors explicitly (``compat.replicated``).
"""
from __future__ import annotations

import dataclasses

from torch.distributed.tensor import DTensor

from repro_torch.compat import DTensorMesh, spec_placements
from repro_torch.runtime.validate import SpgemmConfigError


def even_spec(spec, shape, axis_names, axis_sizes) -> tuple:
    """``spec`` with every dim that its axes do not split evenly replicated
    (``None``). GSPMD pads such a dim (a decode batch of 1 over 16 data
    shards); a DTensor sharded unevenly cannot be viewed or reshaped
    through that dim, so the port's constraints keep it whole on every
    shard, as ``batch_spec`` and the reference's ``cells._resolve_dp`` do
    for inputs."""
    size = dict(zip(axis_names, axis_sizes))
    out = []
    for entry, n in zip(spec, shape):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        split = 1
        for name in names:
            split *= size.get(name, 1)
        out.append(entry if n % split == 0 else None)
    return tuple(out) + tuple(spec[len(out):])


def check_mesh(mesh) -> DTensorMesh:
    """``mesh`` if it is a data x model mesh; ``SpgemmConfigError`` if not
    (a local-stack ``compat.Mesh`` is the sharded SpGEMM's)."""
    if not isinstance(mesh, DTensorMesh):
        raise SpgemmConfigError(
            f"the model paths take a data x model mesh (compat.make_device_mesh, "
            f"launch.mesh.make_test_mesh), got {mesh!r}")
    return mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolves tensor roles to specs for a concrete mesh shape."""

    dp_axes: tuple = ("data",)  # ('pod','data') on the multi-pod mesh
    tp_axis: str | None = "model"
    tp_size: int = 16
    dp_size: int = 1  # product of the data-axis sizes (for FSDP divisibility)
    enabled: bool = True
    # sequence-parallel residuals (train/prefill)
    sp_residual: bool = True
    # decode mode: KV caches stay sequence-sharded; q heads replicate
    decode: bool = False
    long_context: bool = False

    # ---- helpers -------------------------------------------------------
    def _tp_if(self, n: int):
        """tp axis if divisible, else None (replicated)."""
        return self.tp_axis if (self.tp_axis and n % self.tp_size == 0) else None

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def constraint(self, x, spec):
        if not self.enabled:
            return x
        if not isinstance(x, DTensor):
            raise SpgemmConfigError(
                f"placing an activation at {spec!r} needs a DTensor on a data x model "
                f"mesh, got a plain {tuple(x.shape)} tensor: place the params and inputs "
                f"(models.place) or use NO_SHARDING")
        names, sizes = x.device_mesh.mesh_dim_names, x.device_mesh.shape
        placements = spec_placements(even_spec(spec, x.shape, names, sizes), names, sizes)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    # ---- parameter specs ----------------------------------------------
    def embed(self, vocab: int, d: int):
        return (self._tp_if(vocab), None)

    def lm_head(self, d: int, vocab: int):
        return (None, self._tp_if(vocab))

    def norm(self):
        return (None,)

    def wq(self, d: int, h: int, hd: int):
        tp = self._tp_if(h)
        if tp:
            return (None, tp, None)
        # non-divisible head count (qwen2's 28 heads): replicate the (small)
        # attention weights; activations are query-sequence-sharded instead
        return (None, None, None)

    def wkv(self, d: int, h: int, hd: int):
        tp = self._tp_if(h)
        if tp:
            return (None, tp, None)
        return (None, None, None)

    def wo(self, h: int, hd: int, d: int):
        tp = self._tp_if(h)
        if tp:
            return (tp, None, None)  # row-parallel: psum after
        return (None, None, None)

    def ffn_in(self, d: int, f: int):
        return (None, self._tp_if(f))

    def ffn_out(self, f: int, d: int):
        return (self._tp_if(f), None)

    def moe_experts(self, e: int, *dims):
        """Experts over model (EP) + FSDP over the data axes on the first
        inner dim (at-rest sharding)."""
        ep = self._tp_if(e)
        inner = [None] * len(dims)
        if dims and self.dp_size > 1 and dims[0] % self.dp_size == 0:
            inner[0] = self.dp
        return (ep, *inner)

    def ssm_inproj(self, d: int, out: int):
        return (None, self._tp_if(out))

    def ssm_outproj(self, d_in: int, d: int):
        return (self._tp_if(d_in), None)

    # ---- role dispatch (param templates carry a role string per leaf) ----
    def spec_for(self, role: str, shape: tuple):
        if role == "wq":
            return self.wq(*shape)
        if role == "wkv":
            return self.wkv(*shape)
        if role == "wo":
            return self.wo(*shape)
        if role == "ffn_in":
            return self.ffn_in(*shape)
        if role == "ffn_out":
            return self.ffn_out(*shape)
        if role == "moe":
            return self.moe_experts(shape[0], *shape[1:])
        if role == "embed":
            return self.embed(*shape)
        if role == "lm_head":
            return self.lm_head(*shape)
        if role == "conv_ch":  # (K, C): channel dim TP
            return (None, self._tp_if(shape[1]))
        if role == "conv_ch1":  # (C,)
            return (self._tp_if(shape[0]),)
        if role == "gate_block":  # (H, bw, bw): heads TP
            return (self._tp_if(shape[0]), None, None)
        if role == "norm":
            return (None,) * len(shape)
        raise SpgemmConfigError(f"unknown param role {role!r}")

    # ---- activation constraints ----------------------------------------
    def residual(self, x):
        """(B, T, d) residual stream: batch over DP, seq over model (SP).
        Seq sharding is dropped when T doesn't divide (e.g. decode T=1)."""
        if x.ndim != 3:
            return x
        seq = self.tp_axis if self.sp_residual else None
        if seq is not None and x.shape[1] % self.tp_size:
            seq = None
        return self.constraint(x, (self.dp, seq, None))

    def gathered(self, x):
        """(B, T, d) input or output of a projection, whole along the
        sequence on every 'model' shard: the sequence-parallel residual's
        all-gather before a column-parallel matmul (GSPMD inserts it for
        the reference), and the row-parallel output reduced whole before
        the residual takes its shard (an all-reduce where GSPMD
        reduce-scatters: its backward then meets a whole gradient). A
        matmul flattens batch and sequence into rows, forward and backward,
        and DTensor cannot view two dims split over two axes as one (torch
        2.11 refuses it)."""
        if not self.enabled or x.ndim != 3:
            return x
        return self.constraint(x, (self.dp, None, None))

    def attn_activations(self, x, n_heads: int):
        """(B, T, H, hd) q/out activations: heads over model when they
        divide, else the query sequence; replicated in decode mode."""
        if self.decode:
            dp = None if self.long_context else self.dp
            return self.constraint(x, (dp, None, None, None))
        tp = self._tp_if(n_heads)
        if tp:
            return self.constraint(x, (self.dp, None, tp, None))
        if self.tp_axis and x.shape[1] % self.tp_size == 0:
            return self.constraint(x, (self.dp, self.tp_axis, None, None))
        return self.constraint(x, (self.dp, None, None, None))

    def attn_kv(self, x, n_heads: int):
        """(B, T, H, hd) repeated KV: head-sharded when divisible, else
        fully replicated over model."""
        if self.decode:
            dp = None if self.long_context else self.dp
            return self.constraint(x, (dp, None, None, None))
        tp = self._tp_if(n_heads)
        return self.constraint(x, (self.dp, None, tp, None))

    def kv_cache_constraint(self, x):
        """(B, S, H, hd) decode cache tensors: seq-dim sharding in decode
        mode."""
        if not self.decode:
            return x
        spec = self.kv_cache_spec(x.shape[0], x.shape[2],
                                  long_context=self.long_context)
        return self.constraint(x, spec)

    def kv_cache_spec(self, batch: int, hkv: int, *, long_context: bool = False):
        """(B, S, Hkv, hd) cache. Long-context (batch < dp size): shard the
        sequence dim over every axis; else batch over DP, seq over model."""
        if long_context:
            axes = tuple(self.dp_axes) + ((self.tp_axis,) if self.tp_axis else ())
            # one axis is named alone, none is None, as PartitionSpec has it
            return (None, axes if len(axes) > 1 else (axes[0] if axes else None), None, None)
        return (self.dp, self.tp_axis, None, None)

    def logits(self, x):
        """(B, T, V) vocab-sharded logits."""
        return self.constraint(x, (self.dp, None, self._tp_if(x.shape[-1])))


NO_SHARDING = ShardingRules(enabled=False, tp_axis=None, tp_size=1)
