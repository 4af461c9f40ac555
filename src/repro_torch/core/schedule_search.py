"""Anytime wave-schedule search (seeded, deterministic local search): the
port's copy of the reference's ``repro.core.schedule_search``.

The greedy list scheduler (:func:`repro_torch.core.collectives._list_schedule`)
packs the message DAG critical-path first with a fixed deterministic
tiebreak.  That tiebreak is one point in a large legal-schedule space:
which ready message wins a contended (source, destination) slot decides
both the final wave count and -- for the striped engine, whose waves ship
their *longest* member window -- the per-wave wire length.  This module
hillclimbs that space:

  * **candidates** are greedy schedules under perturbed ready-queue
    tiebreaks -- seeded ``numpy.random.RandomState`` permutations plus,
    for the striped engine, deterministic window-length orders (longest-
    and shortest-window first), handed to ``_list_schedule(priority=...)``
    so every candidate is still a legal critical-path schedule;
  * **scoring** is the compiled artifact's own cost: wave count for the
    pipelined/fused engines (their :class:`CostModel` cost is monotone in
    waves), and ``(waves, CostModel().striped_allreduce)`` for the
    striped engine, whose makespan depends on how windows are packed into
    waves, not just on how many waves there are;
  * **acceptance** is strict improvement only; otherwise the *greedy spec
    object itself* is returned, so a search that finds nothing keeps
    every cache keyed to the identical incumbent;
  * at ``verify="full"`` every candidate's list schedule self-checks
    (:func:`~repro_torch.core.collectives._check_list_schedule`), so an
    illegal wave cannot replace a legal incumbent.

Search results are memoized per (schedule key, engine, seed); the whole
pass is deterministic for a fixed seed.  Root search
(:func:`search_roots`, the ``allreduce_schedule(..., roots="search")``
hook) is the same strict-improvement rule one level up: a center root
(depth-optimal by the tree-center theorem) is replaced only by a strictly
shallower neighbor, so searched roots are never deeper than
``_best_root``'s.
"""
from __future__ import annotations

import numpy as np

from .collectives import (AG_DOWN, AG_UP, BCAST, REDUCE, RS_DOWN, RS_UP,
                          CostModel,
                          AllreduceSchedule, _best_root, _fused_round,
                          _list_schedule, _message_dag, _pipe_wave,
                          _resolve_verify, _sched_key, _split_tagged,
                          _striped_dag, _striped_op, _striped_tree,
                          _striped_wave, _RS_KINDS, FusedAllreduceSpec,
                          PipelinedAllreduceSpec, StripedCollectiveSpec,
                          fused_spec_from_schedule,
                          pipelined_spec_from_schedule,
                          striped_spec_from_schedule)
from .graph import tree_depth_levels

#: payload the striped makespan is scored at (64 MiB of f32 -- large
#: enough that window packing, not alpha, decides the ranking)
SCORE_NBYTES = 64 * 1024 * 1024

#: random-restart count per engine (on top of the deterministic
#: window-order candidates); every restart is one greedy re-pack
RESTARTS = 6

_SEARCH_CACHE: dict = {}


# ---------------------------------------------------------------------------
# root search
# ---------------------------------------------------------------------------

def _depth_of(tree, root) -> int:
    return len(tree_depth_levels(tree, root))


def search_roots(n: int, trees) -> list:
    """Strict-improvement root search per tree: start from the tree
    center (``_best_root``, depth-optimal), probe its tree neighbors, and
    move only to a strictly shallower root.  Never returns a root deeper
    than the center's depth -- the property test pins this against
    ``_best_root_probe``."""
    roots = []
    for t in trees:
        tree = frozenset(t)
        best = _best_root(n, tree)
        best_d = _depth_of(tree, best)
        improved = True
        while improved:
            improved = False
            nbrs = sorted({v for e in tree if best in e for v in e}
                          - {best})
            for cand in nbrs:
                d = _depth_of(tree, cand)
                if d < best_d:
                    best, best_d = cand, d
                    improved = True
                    break
        roots.append(best)
    return roots


# ---------------------------------------------------------------------------
# wave-schedule search
# ---------------------------------------------------------------------------

def _priorities(rng, m, extra=()):
    """Candidate tiebreak streams: seeded random permutations plus the
    engine's deterministic ``extra`` orders (each an int sequence of
    length m; lower wins a contended slot)."""
    for pr in extra:
        yield pr
    for _ in range(RESTARTS):
        yield rng.permutation(m)


def search_pipelined_spec(sched: AllreduceSchedule, axis_names,
                          verify=None, seed: int = 0
                          ) -> PipelinedAllreduceSpec:
    """Hillclimb of the pipelined wave program.  Pipelined cost is
    monotone in wave count (``steps = waves + S - 1``), so the score is
    the mixed program's wave count; candidates must also not lengthen
    the quantized program.  Returns the greedy spec object itself when no
    candidate strictly improves."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "pipelined", "search", seed)
    hit = _SEARCH_CACHE.get(key)
    if hit is not None:
        return hit
    greedy = pipelined_spec_from_schedule(sched, axes, verify)
    msgs, deps = _message_dag(sched)
    rng = np.random.RandomState(seed)
    best_take, best_score = None, len(greedy.waves)
    best_pr = None
    for pr in _priorities(rng, len(msgs)):
        take = _list_schedule(msgs, deps, priority=pr)
        if len(take) < best_score:
            best_take, best_score, best_pr = take, len(take), pr
    if best_take is None:
        _SEARCH_CACHE[key] = greedy
        return greedy
    n, k = sched.n, sched.k
    deep = _resolve_verify(verify) == "full"
    red = _list_schedule(msgs, deps, kinds={REDUCE}, priority=best_pr,
                         verify=deep)
    bc = _list_schedule(msgs, deps, kinds={BCAST}, priority=best_pr,
                        verify=deep)
    if len(red) + len(bc) > len(greedy.q8_waves):
        red = _list_schedule(msgs, deps, kinds={REDUCE}, verify=deep)
        bc = _list_schedule(msgs, deps, kinds={BCAST}, verify=deep)
    waves = tuple(_pipe_wave(n, k, msgs, t) for t in best_take)
    q8 = tuple(_pipe_wave(n, k, msgs, t) for t in red + bc)
    spec = PipelinedAllreduceSpec(n=n, k=k, axes=axes, depth=sched.depth,
                                  waves=waves, q8_waves=q8,
                                  q8_boundary=len(red), key=key)
    _SEARCH_CACHE[key] = spec
    return spec


def _striped_makespan(spec) -> float:
    return CostModel().striped_allreduce(SCORE_NBYTES, spec)


def search_striped_spec(sched: AllreduceSchedule, axis_names,
                        verify=None, seed: int = 0
                        ) -> StripedCollectiveSpec:
    """Hillclimb of the striped wave program.  Score is lexicographic
    ``(waves, modelled makespan)``: the makespan
    (:meth:`CostModel.striped_allreduce`) sums each wave's *longest*
    member window, so packing long and short stripe windows into separate
    waves beats the greedy mix even at equal wave counts.  Deterministic
    window-length orders (longest-/shortest-window first) seed the
    candidate set alongside the random restarts."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "striped", "search", seed)
    hit = _SEARCH_CACHE.get(key)
    if hit is not None:
        return hit
    greedy = striped_spec_from_schedule(sched, axes, verify)
    n, k = sched.n, sched.k
    trees = greedy.trees
    msgs, deps = _striped_dag(sched, trees)
    m = len(msgs)

    def win(i):
        j, kind, s, d = msgs[i]
        c = s if kind in (RS_UP, AG_UP) else d    # the child endpoint
        size = int(trees[j].size[c])
        return size if kind in (RS_DOWN, AG_UP) else n - size

    wins = [win(i) for i in range(m)]
    extra = ([-w for w in wins], wins)            # longest / shortest first
    rng = np.random.RandomState(seed)

    def build(pr, tag):
        deep = _resolve_verify(verify) == "full"
        kinds_sets = (None, _RS_KINDS, frozenset({AG_UP, AG_DOWN}))
        programs = [tuple(_striped_wave(n, msgs, t, trees)
                          for t in _list_schedule(msgs, deps, kinds=ks,
                                                  op_of=_striped_op,
                                                  priority=pr,
                                                  verify=deep))
                    for ks in kinds_sets]
        return StripedCollectiveSpec(
            n=n, k=k, axes=axes, depth=sched.depth, trees=trees,
            waves=programs[0], rs_waves=programs[1], ag_waves=programs[2],
            key=(*key, tag))

    best, best_score = None, (len(greedy.waves), _striped_makespan(greedy))
    for tag, pr in enumerate(_priorities(rng, m, extra)):
        cand = build(pr, tag)
        score = (len(cand.waves), _striped_makespan(cand))
        if score < best_score:
            best, best_score = cand, score
    if best is None:
        _SEARCH_CACHE[key] = greedy
        return greedy
    spec = StripedCollectiveSpec(
        n=n, k=k, axes=axes, depth=sched.depth, trees=trees,
        waves=best.waves, rs_waves=best.rs_waves, ag_waves=best.ag_waves,
        key=key)
    _SEARCH_CACHE[key] = spec
    return spec


def search_fused_spec(sched: AllreduceSchedule, axis_names,
                      verify=None, seed: int = 0) -> FusedAllreduceSpec:
    """Hillclimb of the round-major fused program: permute each global
    round's message order before the greedy ppermute split
    (``_split_tagged`` keeps the first legal message per slot, so order
    decides the fan-in overflow sub-round count).  Score is total
    rounds."""
    axes = tuple(axis_names)
    key = (*_sched_key(sched, axes), "fused", "search", seed)
    hit = _SEARCH_CACHE.get(key)
    if hit is not None:
        return hit
    greedy = fused_spec_from_schedule(sched, axes, verify)
    rng = np.random.RandomState(seed)

    def build(shuffle):
        phases = {}
        for phase in ("reduce", "bcast"):
            rounds = []
            for ms in sched.global_rounds(phase):
                ms = list(ms)
                if shuffle:
                    ms = [ms[i] for i in rng.permutation(len(ms))]
                rounds.extend(_fused_round(sched.n, wave)
                              for wave in _split_tagged(ms))
            phases[phase] = tuple(rounds)
        return phases

    best, best_score = None, greedy.num_collectives
    for _ in range(RESTARTS):
        phases = build(True)
        score = len(phases["reduce"]) + len(phases["bcast"])
        if score < best_score:
            best, best_score = phases, score
    if best is None:
        _SEARCH_CACHE[key] = greedy
        return greedy
    spec = FusedAllreduceSpec(n=sched.n, k=sched.k, axes=axes,
                              depth=sched.depth,
                              reduce_rounds=best["reduce"],
                              bcast_rounds=best["bcast"], key=key)
    _SEARCH_CACHE[key] = spec
    return spec
