"""The logical-axis rule table, resolved to DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``.

The paper's two-level distribution (watersheds -> nodes, CNN heads ->
devices) is the reference's rule table (``repro/distributed/sharding.py``),
copied here:

  * ``batch`` -> the watershed / input-pipeline axis: ("pod", "data");
  * ``heads`` / ``kv_heads`` / ``experts`` / ``ffn`` / ``inner`` /
    ``vocab`` / ``hidden`` / ``pix_heads`` -> the head-partitioning axis
    "model";
  * everything else (embed, seq, state, conv, ...) replicated, but for the
    ``fsdp`` parameter variant (embed over the batch axes) and
    ``sequence_parallel`` (seq over "model").

A logical-axes tuple resolves by the reference's ``resolve_pspec`` rules:
a mesh axis that does not divide its dim is dropped, and a mesh axis is
never used twice. The resolution is kept in the reference's form (one
entry per dim: None, a mesh-axis name or a tuple of them), which is what
the tests hold against the reference, and as the ``Shard(d)`` /
``Replicate()`` placement of each mesh dim, which is what DTensor takes.

Every rank makes the same host values from the seed, so ``distribute``
builds each rank's DTensor with ``DTensor.from_local`` from that rank's
slice of the full value: nothing is scattered. ``constrain`` is the
reference's ``with_sharding_constraint``: a ``redistribute`` of a DTensor
inside a ``logical_sharding`` context, the identity on a plain tensor or
outside one. ``local_kernel`` calls a kernel's wrapper on each rank's
local tensors through ``local_map``.

A mesh argument may be a ``DeviceMesh`` or, where only the rules are
resolved (no process group), a :class:`MeshShape` stand-in.
"""
from __future__ import annotations

import contextlib
import math
from typing import (
    Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple,
    Union,
)

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

Axes = Tuple[Optional[str], ...]
MeshAxis = Union[None, str, Tuple[str, ...]]
Placements = Tuple[Placement, ...]

BATCH_AXES = ("pod", "data")


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices: what the rules read."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_shape(mesh) -> MeshShape:
    """(axis names, sizes) of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def mesh_sizes(mesh) -> Dict[str, int]:
    ms = mesh_shape(mesh)
    return dict(zip(ms.axis_names, ms.shape))


def is_axes(x: Any) -> bool:
    """True for a logical-axes tuple leaf."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


# ---------------------------------------------------------------------------
# Rule tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------
def make_rules(cfg=None, *, mesh=None, tp_mode: Optional[str] = None,
               sequence_parallel: bool = False,
               fsdp: bool = False) -> Dict[str, MeshAxis]:
    """Logical axis -> mesh axis assignment. ``cfg`` supplies ``tp_mode``;
    ``mesh`` decides whether a "pod" axis exists. ``fsdp=True`` is the
    parameter variant (``embed`` over the batch axes), for the param and
    optimizer trees only."""
    tp = tp_mode or (getattr(cfg, "tp_mode", None) or "heads")
    names = mesh_shape(mesh).axis_names if mesh is not None \
        else ("data", "model")
    batch: MeshAxis = tuple(a for a in BATCH_AXES if a in names) or None
    if isinstance(batch, tuple) and len(batch) == 1:
        batch = batch[0]
    model = "model" if "model" in names else None
    return {
        "batch": batch,
        "seq": model if sequence_parallel else None,
        "embed": batch if fsdp else None,
        "heads": model if tp == "heads" else None,
        "kv_heads": model if tp == "heads" else None,
        "head_dim": None,
        "ffn": model,
        "vocab": model,
        "experts": model,
        "inner": model,
        "state": None,
        "conv": None,
        "pix_heads": model,
        "pixels": None,
        "time": None,
        "hidden": model,
        "cache_seq": model if cache_needs_seq_shard(cfg, mesh, tp) else None,
        "pages": batch,
    }


def cache_needs_seq_shard(cfg, mesh, tp_mode: Optional[str] = None) -> bool:
    """True when the decode KV cache must shard its sequence axis: an
    ``ffn``-mode arch, or kv_heads that do not divide the model axis."""
    tp = tp_mode or (getattr(cfg, "tp_mode", None) or "heads")
    if tp == "ffn":
        return True
    if cfg is None or mesh is None:
        return False
    kv = getattr(cfg, "num_kv_heads", 0)
    return bool(kv) and kv % mesh_sizes(mesh).get("model", 1) != 0


def resolve_axes(axes: Axes, shape: Sequence[int], mesh,
                 rules: Mapping[str, MeshAxis]) -> Tuple[MeshAxis, ...]:
    """A logical-axes tuple -> one mesh assignment a dim, in the form of
    the reference's ``resolve_pspec``: a mesh axis (or group) that does not
    divide its dim is dropped, and a mesh axis is used at most once (the
    first dim that takes it keeps it)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not fit shape {tuple(shape)}")
    sizes = mesh_sizes(mesh)
    entries = []
    for dim, ax in zip(shape, axes):
        a = rules.get(ax) if ax is not None else None
        if a is not None:
            names = a if isinstance(a, tuple) else (a,)
            if dim % math.prod(sizes[n] for n in names):
                a = None
        entries.append(a)
    seen: set = set()
    out = []
    for e in entries:
        names = e if isinstance(e, tuple) else (e,) if e else ()
        if any(n in seen for n in names):
            out.append(None)
        else:
            out.append(e)
            seen.update(names)
    return tuple(out)


def placements_of(assignment: Sequence[MeshAxis], mesh) -> Placements:
    """Per-dim assignments -> the placement of each mesh dim: ``Shard(d)``
    where dim d takes that mesh axis, else ``Replicate()``. A mesh dim of
    size 1 holds the whole tensor and is ``Replicate()`` (the same layout;
    DTensor's view rules refuse some splits of a size-1 shard)."""
    ms = mesh_shape(mesh)
    out = []
    for name, size in zip(ms.axis_names, ms.shape):
        dims = [d for d, a in enumerate(assignment)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def resolve(axes: Axes, shape: Sequence[int], mesh,
            rules: Mapping[str, MeshAxis]) -> Placements:
    """A logical-axes tuple -> the placements of a tensor of ``shape``."""
    return placements_of(resolve_axes(axes, shape, mesh, rules), mesh)


def tree_placements(axes_tree: Mapping[str, Axes], shapes: Mapping[str, Any],
                    mesh, rules: Mapping[str, MeshAxis]) -> Dict[str, Placements]:
    """A flat dict of logical axes -> the placements of each leaf (shapes
    from tensors, arrays or shape tuples)."""
    return {k: resolve(axes_tree[k], tuple(getattr(v, "shape", v)), mesh,
                       rules) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# Placing values
# ---------------------------------------------------------------------------
def local_slice(value, mesh, placements: Placements):
    """This rank's block of the full ``value`` (a tensor or an array) under
    ``placements``: the resolver only shards dims the mesh divides, so the
    blocks are even."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            size = value.shape[p.dim] // n
            idx = [slice(None)] * value.ndim
            idx[p.dim] = slice(coord[i] * size, (coord[i] + 1) * size)
            value = value[tuple(idx)]
    return value


def distribute(value, mesh, placements: Placements,
               device: Optional[torch.device] = None,
               dtype: Optional[torch.dtype] = None) -> DTensor:
    """The DTensor whose global value is ``value`` (the same on every rank),
    built by ``DTensor.from_local`` from this rank's slice: no collective.
    The local block owns its storage: a block that is still a view into a
    larger one (the value already on the device in the dtype asked for)
    is copied, so that the rank keeps only its shard alive."""
    full = value if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    shape = full.shape
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    local = local_slice(full, mesh, placements)
    local = local.to(device=device or mesh.device_type,
                     dtype=dtype or local.dtype).contiguous()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        local = local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def distribute_tree(tree: Mapping[str, Any], axes_tree: Mapping[str, Axes],
                    mesh, rules: Mapping[str, MeshAxis], *,
                    device: Optional[torch.device] = None,
                    float32: bool = True) -> Dict[str, DTensor]:
    """A flat dict of full host values -> DTensors placed by the rules;
    floating leaves as float32 (``float32``)."""
    out = {}
    for k, v in tree.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        dt = torch.float32 if float32 and t.is_floating_point() else None
        out[k] = distribute(t, mesh, resolve(axes_tree[k], t.shape, mesh,
                                             rules), device, dt)
    return out


def full_host(x) -> np.ndarray:
    """A tensor or DTensor's full value as a numpy array on the host (the
    checkpoints' form)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def shard_range(x: DTensor, dim: int) -> Tuple[int, int]:
    """(start, size) of this rank's block of ``x`` along ``dim`` (a dim
    split over several mesh dims is split by the first, then each block by
    the next, as ``local_slice`` cuts it)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            start += coord[i] * size
    return start, size


def block_of(value: torch.Tensor, x: DTensor, lead: int = 0) -> torch.Tensor:
    """This rank's block of ``value``, a full tensor whose dims are those of
    ``x`` from dim ``lead`` on (``value`` may have extra leading dims of its
    own: its last ``x.dim() - lead`` dims are cut as ``x``'s)."""
    extra = value.dim() - (x.dim() - lead)
    for d in range(lead, x.dim()):
        start, size = shard_range(x, d)
        if size != x.shape[d]:
            value = value.narrow(extra + d - lead, start, size)
    return value


class Rows:
    """Row ids along dim 0 for ``put_rows``/``take_rows``: the host ints,
    and on a plain tensor their index on its device, made once however
    many tensors one call writes or reads (one id indexes with no copy)."""

    def __init__(self, ids):
        self.ids = [int(r) for r in ids]
        self._index = {}

    def index(self, device):
        if len(self.ids) == 1 and self.ids[0] >= 0:
            return slice(self.ids[0], self.ids[0] + 1)
        if device not in self._index:
            self._index[device] = torch.tensor(self.ids, dtype=torch.long,
                                               device=device)
        return self._index[device]


def _rows(rows) -> Rows:
    return rows if isinstance(rows, Rows) else Rows(rows)


def put_rows(x, rows, value: torch.Tensor) -> None:
    """``x[rows] = value`` in place, for a plain tensor or, on local blocks,
    a DTensor: ``rows`` host ints along dim 0 (or their ``Rows``), ``value``
    the full rows (len(rows), *x.shape[1:]); each rank writes the rows it
    holds, the part of each in its block. No collective."""
    rows = _rows(rows)
    if not isinstance(x, DTensor):
        x[rows.index(x.device)] = value.to(device=x.device, dtype=x.dtype)
        return
    start, size = shard_range(x, 0)
    mine = [(i, r - start) for i, r in enumerate(rows.ids)
            if start <= r < start + size]
    if not mine:
        return
    src = block_of(value.to(device=x.to_local().device, dtype=x.dtype), x,
                   lead=1)
    loc = x.to_local()
    idx = torch.tensor([m[1] for m in mine], device=loc.device)
    loc[idx] = src[torch.tensor([m[0] for m in mine], device=src.device)]


def take_rows(x, rows) -> torch.Tensor:
    """``x[rows]`` as a plain tensor whole on every rank (a copy), for a
    plain tensor or a DTensor: ``rows`` host ints along dim 0 (or their
    ``Rows``). On a mesh each rank takes the rows it holds (zeros for the
    others), a Partial sum over the mesh dims that split dim 0 brings them
    together, and the other splits are gathered: the collective moves just
    these rows."""
    rows = _rows(rows)
    if not isinstance(x, DTensor):
        idx = rows.index(x.device)
        return x[idx].clone() if isinstance(idx, slice) else x[idx]
    loc = x.to_local()
    start, size = shard_range(x, 0)
    held = [start <= r < start + size for r in rows.ids]
    idx = torch.tensor([r - start if h else 0
                        for r, h in zip(rows.ids, held)], dtype=torch.long,
                       device=loc.device)
    mask = torch.tensor(held, device=loc.device).reshape(
        (-1,) + (1,) * (loc.dim() - 1))
    part = torch.where(mask, loc[idx], torch.zeros((), dtype=loc.dtype,
                                                   device=loc.device))
    shape = (len(rows.ids),) + tuple(x.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    pl = tuple(Partial() if p == Shard(0) else p for p in x.placements)
    return DTensor.from_local(part, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=stride).full_tensor()


def rows_like(value: torch.Tensor, x: DTensor) -> DTensor:
    """The DTensor of whole rows ``value`` (k, *x.shape[1:]) placed as
    ``x`` but for dim 0, which is whole: the rows of a slot as a step on
    one slot takes them."""
    pl = tuple(Replicate() if p == Shard(0) else p for p in x.placements)
    return distribute(value, x.device_mesh, pl, value.device)


def stacked_like(x, like):
    """``x``, rows of ``like`` stacked on a new leading axis, placed as
    ``like`` (a plain tensor passes through; a DTensor already so placed
    moves nothing)."""
    if not isinstance(like, DTensor):
        return x
    pl = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
               for p in like.placements)
    return x.redistribute(like.device_mesh, pl)


class _PinGrad(torch.autograd.Function):
    """The identity, whose backward redistributes a gradient whose token
    dims would not fold cleanly (``_folds_cleanly``) to the forward
    value's placements (a Partial one reduced)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if _folds_cleanly(g) else to_placements(g, ctx.placements)


def _folds_cleanly(x: DTensor) -> bool:
    """Whether ``x``'s token dims (all but the last) fold into one whose
    split is plain: only the first is split, and evenly, and no sum is
    pending (a Partial one DTensor may reduce-scatter over the tokens)."""
    ways = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if p.is_partial():
            return False
        if isinstance(p, Shard):
            if 0 < p.dim < x.ndim - 1:
                return False
            ways *= size if p.dim == 0 else 1
    return x.shape[0] % ways == 0


def pin_grad(x):
    """``x``, whose gradient arrives placed as ``x`` is where its token
    dims would not fold cleanly (the identity on a plain tensor or one
    that needs no gradient). Behind a gate's product or a concatenation
    of unlike placements DTensor may split a projection's output
    gradient on "model" too: over the batch (a cheap plan, kept: the
    matmul's backward then gathers the small weight, not the
    activations), or over the sequence, or leave its sum over "model"
    pending. Split over the sequence or over a batch that does not
    divide, or reduce-scattered so, the weight gradient contracts a token
    axis strided-split over "model", which DTensor plans from an index
    tensor of the whole token axis: under fake tensors (the dry run) the
    plan fails, and with the index arithmetic done on integers it took
    ~2 min of CPU time for a 2-layer mamba2-130m step at (2, 16, 16).
    There the gradient takes the forward value's placements."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _PinGrad.apply(x)


def local(x) -> torch.Tensor:
    """``x``'s local block (``x`` itself for a plain tensor)."""
    return x.to_local() if isinstance(x, DTensor) else x


def full(x) -> torch.Tensor:
    """``x``'s full value as a plain tensor on its device (a collective for
    a split DTensor)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def assign(x, value: torch.Tensor) -> None:
    """``x[...] = value`` in place from the full ``value``: on a DTensor,
    each rank copies its block (no collective)."""
    if isinstance(x, DTensor):
        x.to_local().copy_(block_of(value, x))
    else:
        x.copy_(value)


def to_placements(x, placements: Placements):
    """``x`` redistributed to ``placements`` (the identity where it already
    has them, and on a plain tensor)."""
    if not isinstance(x, DTensor) or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# Activation constraints (the identity outside a logical_sharding context)
# ---------------------------------------------------------------------------
class _Context:
    """The open ``logical_sharding`` context: process-wide, not per
    thread, because autograd runs a CUDA backward (and the forward that
    remat recomputes there) on its own device threads, where a
    thread-local context would be closed and ``constrain`` would place
    the recomputed activations otherwise than the forward did."""
    val = None


_CTX = _Context()


@contextlib.contextmanager
def logical_sharding(mesh, rules: Mapping[str, MeshAxis]):
    """Enable ``constrain`` in model code for this mesh and rule table."""
    prev = getattr(_CTX, "val", None)
    _CTX.val = (mesh, rules)
    try:
        yield
    finally:
        _CTX.val = prev


@contextlib.contextmanager
def suspend_logical_sharding():
    """Disable ``constrain`` (inside a ``local_map`` body)."""
    prev = getattr(_CTX, "val", None)
    _CTX.val = None
    try:
        yield
    finally:
        _CTX.val = prev


def mesh_context(mesh, rules: Optional[Mapping[str, MeshAxis]]):
    """What a step on ``mesh`` runs in: ``logical_sharding`` with
    ``rules`` and DTensor's ``implicit_replication`` (a plain tensor, such
    as a position table, counts as replicated); nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(logical_sharding(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


def current():
    """(mesh, rules) of the open ``logical_sharding`` context, or None."""
    return getattr(_CTX, "val", None)


def constrain(x, axes: Axes):
    """``x`` redistributed to the placements its logical ``axes`` resolve
    to; the identity on a plain tensor or outside a context."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return to_placements(x, resolve(axes, x.shape, mesh, rules))


# ---------------------------------------------------------------------------
# Kernels on local shards
# ---------------------------------------------------------------------------
def replicated_over(placements: Placements, mesh, names: Sequence[str]
                    ) -> Placements:
    """``placements`` with every mesh dim in ``names`` made Replicate."""
    dims = mesh_shape(mesh).axis_names
    return tuple(Replicate() if n in names else p
                 for n, p in zip(dims, placements))


def weight_grad_placements(weight: Placements, act: Placements) -> Placements:
    """Where a weight is replicated over a mesh dim that shards the
    activation, each rank's local gradient is a part of the sum: Partial."""
    return tuple(Partial() if isinstance(w, Replicate)
                 and isinstance(a, Shard) else w
                 for w, a in zip(weight, act))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grad(x):
    """``x`` (a local block in a ``local_map`` body), whose gradient leaves
    the body contiguous: a gradient that autograd computes as a transposed
    view (an einsum's) would go back into a DTensor whose global strides
    claim a layout its local block does not have, and a later view of it
    (a matmul's backward folding (B, S) into one axis) fails."""
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return _ContiguousGrad.apply(x)
    return x


def local_kernel(fn: Callable, args: Sequence[Any],
                 targets: Sequence[Optional[Placements]],
                 outs: Sequence[Placements], *,
                 grads: Optional[Sequence] = None, mesh=None):
    """``fn(*args)`` on each rank's local tensors through ``local_map``:
    every DTensor argument is first redistributed to its entry of
    ``targets`` (None for a non-tensor argument), ``grads`` gives their
    gradients' placements (the targets by default), and the outputs are
    DTensors with the placements in ``outs``, one entry an output (a
    single entry: ``fn`` returns one tensor). Kernel wrappers then see
    the plain CUDA (or CPU) tensors they take."""
    from torch.distributed.tensor.experimental import local_map
    if mesh is None:
        mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = [to_placements(a, t) if t is not None else a
            for a, t in zip(args, targets)]

    def body(*local):
        with suspend_logical_sharding():
            return fn(*(_contiguous_grad(t) for t in local))
    return local_map(body, out_placements=tuple(tuple(o) for o in outs),
                     in_placements=tuple(targets),
                     in_grad_placements=tuple(grads) if grads else None,
                     device_mesh=mesh)(*args)


def local_rows(fn: Callable, acts: Sequence[DTensor],
               weights: Sequence[DTensor] = (), n_out: int = 1):
    """``fn(*acts, *weights)`` on local blocks for a kernel that needs its
    weights whole: every argument is replicated over the non-batch mesh
    axes (an all-gather of what the rules split there), the activations
    keep their batch-axis blocks (they must share one placement, on the
    same leading dims) and each weight its own (the replica axis, or
    whole). The ``n_out`` outputs are placed as the activations; a
    weight's gradient is Partial over a batch axis that splits the
    activations but not the weight."""
    mesh = acts[0].device_mesh
    model = [n for n in mesh_shape(mesh).axis_names if n not in BATCH_AXES]
    at = replicated_over(acts[0].placements, mesh, model)
    wt = [replicated_over(w.placements, mesh, model) for w in weights]
    targets = [at] * len(acts) + wt
    grads = [at] * len(acts) + [weight_grad_placements(t, at) for t in wt]
    return local_kernel(fn, [*acts, *weights], targets, [at] * n_out,
                        grads=grads, mesh=mesh)


def embedding_lookup(table: DTensor, ids: DTensor) -> DTensor:
    """``table[ids]`` on local blocks, as a vocab-parallel embedding: each
    rank looks up the ids of its block of the vocab (those of other ranks
    read a zero row), so over a mesh dim that splits the vocab the output
    is a Partial sum, which ``constrain`` reduces, and each row's gradient
    stays on its rank. A split of the embedding dim (FSDP) is gathered;
    the ids keep their batch split."""
    import torch.nn.functional as F
    mesh = table.device_mesh
    names = mesh_shape(mesh).axis_names
    tt = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    it = tuple(p if p.is_shard() else Replicate() for p in ids.placements)
    split = [i for i, p in enumerate(tt) if p == Shard(0)]
    rows = table.shape[0] // math.prod(mesh.size(i) for i in split)
    first = 0
    for i in split:          # one vocab split in the rules ("model")
        first = first * mesh.size(i) + mesh.get_local_rank(names[i])
    first *= rows

    def body(tl, il):
        if not split:
            return F.embedding(il, tl)
        local = il - first
        mine = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(mine, local, 0), tl)
        return out * mine[..., None].to(out.dtype)
    out = tuple(Partial() if i in split else it[i] for i in range(len(tt)))
    return local_kernel(body, [table, ids], [tt, it], [out], mesh=mesh,
                        grads=[weight_grad_placements(tt, it), it])


def is_distributed(x) -> bool:
    return isinstance(x, DTensor)
