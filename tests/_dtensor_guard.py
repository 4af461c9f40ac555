"""DTensor made to refuse, on a later torch, what torch 2.11 refuses.

The card's torch (2.11) stops three things that this sandbox's torch
(2.13) runs, each in DTensor's sharding propagation:

* a linear pointwise op (``add``, ``sub``) that follows an operand holding
  a partial sum (the arg with the most shards, then the most dims) asks
  every other operand for the same placement, so a split operand is to
  become a partial sum: "redistribute from S(0) to P(sum) not supported
  yet" (torch 2.13 reduce-scatters the partial sum instead);
* a strict view (``view``, ``_unsafe_view``; an ``einsum``'s flattening)
  that flattens a split dim behind another dim: "Attempted to flatten
  multiple dimensions, with dimension i being sharded";
* ``index_put_``, for which it has no sharding rule.

:func:`refusing_as_torch_2_11` raises on each of them, and on any
explicit redistribution from ``Shard`` to ``Partial``.  Install it before
the process's first DTensor op: DTensor caches each op's propagation.
"""
from __future__ import annotations

import contextlib

LINEAR_BINARY = ("add.Tensor", "add_.Tensor", "sub.Tensor", "sub_.Tensor")
STRICT_VIEWS = ("view.default", "_unsafe_view.default")
NO_RULE = ("index_put_.default", "index_put.default",
           "_index_put_impl_.default")


def _op_name(op) -> str:
    return f"{op._schema.name.split('::')[-1]}.{op._overloadname}"


def _shard_to_partial(current, target):
    for c, t in zip(current, target):
        if c.is_shard() and t.is_partial():
            raise RuntimeError(f"redistribute from {c} to {t} not supported "
                               "yet (refused as torch 2.11 refuses it)")


def _check_linear(name, specs):
    if len(specs) < 2:
        return
    if name.endswith("_.Tensor"):           # in place: follows the first
        follow = specs[0]
    else:                                   # the most shards, then dims
        follow = specs[0]
        for s in specs[1:]:
            if (s.num_shards, s.ndim) > (follow.num_shards, follow.ndim):
                follow = s
    for other in specs:
        if other is not follow:
            _shard_to_partial(other.placements, [
                p if p.is_partial() else other.placements[m]
                for m, p in enumerate(follow.placements)])


def _check_view(spec, size):
    from torch.distributed.tensor._ops._view_ops import (Flatten, Split,
                                                         view_groups)

    def sharded(d):
        return any(p.is_shard(d) for p in spec.placements)

    def check(cmd):
        if isinstance(cmd, Split):
            check(cmd.input_dim)
        elif isinstance(cmd, Flatten):
            for i, d in enumerate(cmd.input_dims):
                if i and sharded(d.input_dim):
                    raise RuntimeError(
                        "Attempted to flatten multiple dimensions, with "
                        f"dimension {d.input_dim} being sharded (refused as "
                        "torch 2.11 refuses it)")

    for cmd in view_groups(tuple(spec.shape), tuple(size)):
        check(cmd)


def _check(schema):
    import torch
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    if torch._C._current_graph_task_id() != -1:
        return          # a backward: its placements are this torch's own
    name = _op_name(schema.op)
    specs = [a for a in schema.args_schema if isinstance(a, DTensorSpec)]
    if not specs:
        return
    if name in LINEAR_BINARY:
        _check_linear(name, specs)
    elif name in STRICT_VIEWS:
        _check_view(schema.args_schema[0], schema.args_schema[1])
    elif name in NO_RULE:
        raise RuntimeError(f"Operator aten.{name} does not have a sharding "
                           "strategy registered (refused as torch 2.11 has "
                           "none)")


@contextlib.contextmanager
def refusing_as_torch_2_11():
    """Within the block, DTensor raises where torch 2.11's would (see the
    module's docstring)."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as red
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    slow = dispatch.OpDispatcher._propagate_op_sharding_dispatch_slow_path
    propagate = ShardingPropagator.propagate
    local = red.redistribute_local_tensor

    def slow_path(self, op_call, args, kwargs, op_info, try_cache):
        _check(op_info.schema)
        return slow(self, op_call, args, kwargs, op_info, try_cache)

    def propagate_checked(self, op_info):
        _check(op_info.schema)
        return propagate(self, op_info)

    def redistribute_local_tensor(tensor, current_spec, target_spec, *a,
                                  **kw):
        _shard_to_partial(current_spec.placements, target_spec.placements)
        return local(tensor, current_spec, target_spec, *a, **kw)

    saved = [(mod, "redistribute_local_tensor",
              getattr(mod, "redistribute_local_tensor"))
             for mod in (red, api, dispatch)]
    for mod, name, _ in saved:
        setattr(mod, name, redistribute_local_tensor)
    dispatch.OpDispatcher._propagate_op_sharding_dispatch_slow_path = \
        slow_path
    ShardingPropagator.propagate = propagate_checked
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)
        dispatch.OpDispatcher._propagate_op_sharding_dispatch_slow_path = \
            slow
        ShardingPropagator.propagate = propagate
