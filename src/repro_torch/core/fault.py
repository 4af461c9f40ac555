"""Fault tolerance on EDST collectives (the reference's
``repro/core/fault.py``; paper Sec. 1.1: "improve
fault-tolerance of large systems").

Strategy mirrors the paper's motivation and PolarFly practice [17]:
  1. *Immediate degraded mode*: a failed link/node kills only the trees that
     use it; surviving trees keep running -- re-split chunks over them.
  2. *Rebuild*: Roskind-Tarjan repacking on the residual graph restores the
     maximum tree count the damaged fabric still supports.
  3. *Straggler mitigation*: chunk sizes are rebalanced so trees in which a
     slow node sits deep (or fans out wide) carry less traffic; a fully
     degenerate tree can be retired without stopping training.
"""
from __future__ import annotations

from dataclasses import dataclass

from .collectives import AllreduceSchedule, allreduce_schedule
from .edst_rt import max_edsts
from .graph import Graph, canon


@dataclass
class FailureEvent:
    links: frozenset = frozenset()   # set of canonical edges
    nodes: frozenset = frozenset()   # node ids (all incident links fail)

    def dead_links(self, g: Graph) -> set:
        dead = {canon(*e) for e in self.links}
        for v in self.nodes:
            for w in g.adj()[v]:
                dead.add(canon(v, w))
        return dead


def surviving_trees(trees, dead_links: set) -> list:
    return [t for t in trees if not (set(t) & dead_links)]


def rebuild_edsts(g: Graph, dead_links: set, k_hint: int | None = None):
    """Max EDST packing on the residual graph (Roskind-Tarjan)."""
    residual = g.without_edges(dead_links)
    if not residual.is_connected():
        return [], residual
    trees, _ = max_edsts(residual, k_hint)
    return trees, residual


@dataclass
class FaultTolerantAllreduce:
    """Schedule manager: degrade on failure, rebuild in the background."""
    graph: Graph
    schedule: AllreduceSchedule
    history: list = None

    def __post_init__(self):
        self.history = self.history or []

    @property
    def k(self) -> int:
        return self.schedule.k

    def on_failure(self, event: FailureEvent) -> "FaultTolerantAllreduce":
        """Link failures degrade to the surviving trees immediately; a node
        failure (which touches every spanning tree) falls through to an
        eager Roskind-Tarjan rebuild on the residual fabric, with the dead
        node excluded from the collective."""
        dead = event.dead_links(self.graph)
        residual = self.graph.without_edges(dead)
        keep = surviving_trees([ts.tree for ts in self.schedule.trees], dead)
        if not keep:
            if event.nodes:
                # drop dead nodes entirely: relabel the residual graph onto
                # the surviving chips and repack
                alive = [v for v in range(self.graph.n)
                         if v not in event.nodes]
                idx = {v: i for i, v in enumerate(alive)}
                sub = Graph(len(alive),
                            {(idx[u], idx[v]) for u, v in residual.edges
                             if u in idx and v in idx}, name="residual")
                trees, _ = max_edsts(sub)
                if not trees:
                    raise RuntimeError("residual fabric disconnected")
                self.history.append(("node-rebuilt", len(trees)))
                return FaultTolerantAllreduce(
                    sub, allreduce_schedule(sub.n, trees), self.history)
            raise RuntimeError("all trees lost; rebuild required before resume")
        degraded = allreduce_schedule(self.graph.n, keep)
        self.history.append(("degraded", len(keep)))
        return FaultTolerantAllreduce(residual, degraded, self.history)

    def rebuild(self, k_hint: int | None = None) -> "FaultTolerantAllreduce":
        trees, residual = rebuild_edsts(self.graph, set(), k_hint)
        if len(trees) <= self.k:
            return self  # current schedule already as good
        sched = allreduce_schedule(self.graph.n, trees)
        self.history.append(("rebuilt", len(trees)))
        return FaultTolerantAllreduce(self.graph, sched, self.history)


def rebalance_chunks(sched: AllreduceSchedule, node_delay: dict) -> list:
    """Straggler mitigation: per-tree chunk fractions, inversely proportional
    to each tree's critical-path delay through slow nodes.

    node_delay: node -> multiplicative slowdown (1.0 = healthy).
    Returns fractions summing to 1 (tree with fraction 0 = retired).
    """
    costs = []
    for ts in sched.trees:
        # critical path: depth rounds, each round slowed by its slowest node
        cost = 0.0
        for rnd in ts.reduce_rounds + ts.bcast_rounds:
            cost += max((node_delay.get(s, 1.0) + node_delay.get(d, 1.0)) / 2
                        for s, d in rnd)
        costs.append(cost)
    inv = [1.0 / c for c in costs]
    total = sum(inv)
    fracs = [x / total for x in inv]
    # retire trees that would carry less than 10% of a fair share
    fair = 1.0 / len(fracs)
    fracs = [0.0 if f < 0.1 * fair else f for f in fracs]
    s = sum(fracs)
    return [f / s for f in fracs]
