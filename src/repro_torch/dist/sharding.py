"""Logical-axis sharding rules (the reference's ``repro/dist/sharding.py``):
axis-name tuples -> :class:`PartitionSpec` -> DTensor placements.

``models.api.ModelAPI.param_axes()`` gives a tree parallel to the
parameters with a tuple of logical axis names per leaf (("embed", "mlp"),
("vocab", "embed"), ...).  ``spec_for`` turns one such tuple into a
:class:`PartitionSpec` for a mesh:

  * "batch" dims map to the data-parallel mesh axes ("pod", "data");
  * exactly one tensor dim maps to the "model" axis, chosen by Megatron-style
    priority (experts > vocab > mlp > heads > kv_heads > head_dim), skipping
    dims the mesh extent does not divide;
  * with ``fsdp=True`` (ZeRO-3) the largest remaining divisible named dim is
    additionally split over the data axes;
  * "layers" (the stacked leading dim) and unnamed dims stay replicated;
    any axis name whose mesh axis is absent falls back to replicated.

Divisibility is always checked against the mesh axis sizes, so shapes that
do not tile (heads=28 on a 16-way model axis, batch=1 on a 16-way data axis)
degrade gracefully instead of erroring.

A mesh is a ``torch.distributed`` :class:`DeviceMesh` (``mesh_dim_names``,
``shape``) or anything with ``axis_names`` and ``devices.shape``, as the
reference's duck-typed stand-ins.  :func:`placements` turns a spec into
the DTensor placements of a :class:`DeviceMesh`, one per mesh dim.
"""
from __future__ import annotations

from typing import NamedTuple

# data-parallel mesh axes, outermost first (flattened row-major = DP rank)
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"
# tensor-parallel candidates, highest priority first
TENSOR_AXES = ("experts", "vocab", "mlp", "heads", "kv_heads", "head_dim")
# never sharded: the stacked layer dim stays whole
UNSHARDED_AXES = ("layers",)


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (split over their product, the first outermost),
    as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> tuple:
    """``(axis names, extents)`` of a :class:`DeviceMesh` or a
    duck-typed mesh with ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def _axis_sizes(mesh) -> dict:
    """axis name -> extent."""
    return dict(zip(*mesh_axes(mesh)))


def _dp_axes(sizes: dict):
    names = tuple(a for a in DATA_AXES if a in sizes)
    total = 1
    for a in names:
        total *= sizes[a]
    return names, total


def _dp_entry(names):
    return names[0] if len(names) == 1 else names


def spec_for(axes, shape, mesh, fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one tensor with logical ``axes`` and ``shape``."""
    axes = tuple(axes)
    shape = tuple(shape)
    sizes = _axis_sizes(mesh)
    dp_names, dp_total = _dp_axes(sizes)
    model_n = sizes.get(MODEL_AXIS, 0)
    entries = [None] * len(shape)

    # 1. batch dims -> data axes
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax == "batch" and dp_names and dim and dim % dp_total == 0:
            entries[i] = _dp_entry(dp_names)

    # 2. one tensor dim -> model axis, by priority then divisibility
    if model_n:
        best = None
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax in TENSOR_AXES and entries[i] is None and dim \
                    and dim % model_n == 0:
                rank = TENSOR_AXES.index(ax)
                if best is None or rank < best[0]:
                    best = (rank, i)
        if best is not None:
            entries[best[1]] = MODEL_AXIS

    # 3. FSDP: largest remaining divisible named dim -> data axes (skipped
    # when a batch dim already holds them -- an axis may appear only once)
    if fsdp and dp_names and all(e is None or e == MODEL_AXIS
                                 for e in entries):
        best = None
        for i, (ax, dim) in enumerate(zip(axes, shape)):
            if ax is None or ax == "batch" or ax in UNSHARDED_AXES:
                continue
            if entries[i] is None and dim and dim % dp_total == 0:
                if best is None or dim > best[0]:
                    best = (dim, i)
        if best is not None:
            entries[best[1]] = _dp_entry(dp_names)

    return PartitionSpec(*entries)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` is split over that mesh axis,
    ``Replicate()`` elsewhere and on an axis of extent 1 (a split over one
    device is no split).  A dim split over several axes (("pod", "data"))
    is split over them in mesh order, outermost first, as DTensor splits a
    dim that more than one mesh dim shards."""
    from torch.distributed.tensor import Replicate, Shard
    names, sizes = mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            if sizes[names.index(ax)] > 1:
                out[names.index(ax)] = Shard(i)
    return tuple(out)


def local_shape(spec, shape, mesh) -> tuple:
    """The shape of one device's shard of a ``shape`` tensor under
    ``spec`` (every split divides, as :func:`spec_for` guarantees)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            out[i] //= sizes[ax]
    return tuple(out)


def owner_stripe_spec(mesh) -> PartitionSpec:
    """PartitionSpec for ZeRO-1 owner-stripe state: the leading axis of a
    ``(ndp, kmax, smax)`` array is the owner vertex, split over the
    data-parallel mesh axes so each holds only its own stripe rows; the
    stripe dims stay unsplit.  Meshes without a DP extent get the
    replicated spec (zero1 has nothing to shard there)."""
    names, total = _dp_axes(_axis_sizes(mesh))
    if not names or total <= 1:
        return PartitionSpec()
    return PartitionSpec(_dp_entry(names))


class Sharding(NamedTuple):
    """A tensor's placement: the mesh and its :class:`PartitionSpec`
    (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def zero1_state_shardings(opt_state, mesh):
    """:class:`Sharding` tree for a
    :class:`repro_torch.optim.sharded.ShardedOptState`: ``mu`` / ``nu``
    take :func:`owner_stripe_spec`, the step replicates.

    Over a process group the port keeps the rows of its vertices in
    :func:`~repro_torch.dist.fabric.vertex_blocks`' blocks, which differ
    by at most one and put the larger first.  Where the world divides the
    DP extent those blocks are the rows ``Shard(0)`` gives each rank.
    Where it does not, this spec describes DTensor's own split
    (ceil-sized chunks, the last ones short: 10 rows over 4 ranks give
    3, 3, 3, 1 against the blocks' 3, 3, 2, 2), which is not how the
    port's ZeRO-1 state lies."""
    stripe = Sharding(mesh, owner_stripe_spec(mesh))
    rep = Sharding(mesh, PartitionSpec())
    return type(opt_state)(rep, stripe, stripe)


def _is_axes_leaf(x) -> bool:
    """A leaf of an axes tree is a (possibly empty) tuple of names/Nones;
    tuples of sub-trees (e.g. a (k, v) cache pair) are interior nodes."""
    return isinstance(x, tuple) and \
        all(a is None or isinstance(a, str) for a in x)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree and trees of the same
    structure (dicts, and tuples of sub-trees)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return type(axes_tree)(map_axes(fn, a, *(t[i] for t in trees))
                           for i, a in enumerate(axes_tree))


def tree_shardings(axes_tree, params_tree, mesh, fsdp: bool = True):
    """:class:`Sharding` tree matching ``params_tree`` (tensors, ``meta``
    tensors or anything with a ``shape``), driven by the parallel
    ``axes_tree`` of logical axis tuples (``ModelAPI.param_axes()`` /
    ``cache_axes()``)."""
    return map_axes(
        lambda ax, p: Sharding(mesh, spec_for(ax, p.shape, mesh, fsdp=fsdp)),
        axes_tree, params_tree)


def distribute(tree, shardings, src_data_rank=None):
    """Each tensor of ``tree`` as a DTensor placed by the parallel
    :class:`Sharding` tree.  With ``src_data_rank=None`` (the default)
    every rank holds the whole tensor already and keeps its own shard, no
    communication; an int scatters the tensor from that rank."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh):
        if isinstance(t, dict):
            return {k: one(t[k], sh[k]) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(one(a, b) for a, b in zip(t, sh))
        return distribute_tensor(t, sh.mesh, sh.placements,
                                 src_data_rank=src_data_rank)
    return one(tree, shardings)


def gather_fsdp(tree):
    """Each DTensor of ``tree`` redistributed to where it is used: its
    split over the data axes undone (the FSDP / ZeRO-3 all-gather before
    a product), its ``model`` split kept.  Differentiable: the gradient
    of a gathered parameter is reduce-scattered back onto its shards.
    Plain tensors pass through."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(p):
        if isinstance(p, dict):
            return {k: one(v) for k, v in p.items()}
        if not isinstance(p, DTensor):
            return p
        names = p.device_mesh.mesh_dim_names
        want = tuple(Replicate() if a in DATA_AXES else pl
                     for a, pl in zip(names, p.placements))
        return p if want == tuple(p.placements) else \
            p.redistribute(p.device_mesh, want)
    return one(tree)
