"""Multi-group co-executed serving: placement math and migration policy.

A copy of the JAX package's ``serve/multigroup.py`` (pure host arithmetic,
no device code).  The server's ``group_batches`` regime runs one
(Paged)BatchGroup per DeviceGroup — per-group block pools, per-group
prefill waves; on one card, each group a CUDA stream of it — instead of
slot-splitting a single batch across groups.  That turns two scheduling
decisions into explicit, testable functions:

- **Placement**: how many decode slots each group owns
  (:func:`proportional_split`, fixed at server construction so paged
  PoolState shapes stay stable across group re-forms), and which group a
  joining wave lands on (:func:`plan_wave`, driven by the scheduler's
  ``placement_weights`` — observed per-group rates for adaptive
  schedulers, fixed proportions for Static).
- **Rebalancing**: when a decode slot should *migrate* between groups at a
  segment boundary (:class:`RateBalancer` for adaptive schedulers,
  :class:`ForceMigrate` for tests and the chip smoke).  A migration is a
  block-table rewrite plus an O(blocks) transfer through the transfer-cache
  machinery (``BatchGroup.migrate_slot_to``,
  ``DeviceGroup.patch_cached``), never a full-cache rewrite.

Everything here is pure host-side arithmetic over the members' public
state; the server applies the returned moves.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

# A planned move: (source member name, source slot index, dest member name).
Move = Tuple[str, int, str]


def proportional_split(weights: Sequence[float], total: int,
                       minimum: int = 0) -> List[int]:
    """Split ``total`` integer units across ``weights`` proportionally
    (largest-remainder rounding).  Every share gets at least ``minimum``
    when the total allows it; ties break on index (deterministic)."""
    n = len(weights)
    if n == 0:
        return []
    w = [max(0.0, float(x)) for x in weights]
    tot = sum(w)
    if tot <= 0.0:
        w, tot = [1.0] * n, float(n)
    base = total - minimum * n
    if base < 0:
        minimum, base = 0, total
    quotas = [base * x / tot for x in w]
    shares = [int(q) for q in quotas]
    rem = base - sum(shares)
    order = sorted(range(n), key=lambda i: (shares[i] - quotas[i], i))
    for i in order[:rem]:
        shares[i] += 1
    return [s + minimum for s in shares]


def plan_wave(weights: Sequence[float], capacities: Sequence[int],
              loads: Sequence[int], n: int) -> List[int]:
    """Place ``n`` joining requests on members.

    Each request goes to the member with the highest weight per unit of
    *resulting* load (current active slots plus requests already assigned
    this wave), skipping members out of capacity; ties break on index.
    Returns per-member counts summing to at most ``n`` (less only when
    capacity runs out)."""
    m = len(weights)
    counts = [0] * m
    w = [max(0.0, float(x)) for x in weights]
    for _ in range(max(0, n)):
        best, best_score = -1, 0.0
        for i in range(m):
            if counts[i] >= capacities[i]:
                continue
            score = w[i] / (loads[i] + counts[i] + 1.0)
            if best < 0 or score > best_score + 1e-12:
                best, best_score = i, score
        if best < 0:
            break
        counts[best] += 1
    return counts


def _active(group) -> int:
    return sum(1 for r in group.slots if r is not None)


class MigrationPolicy:
    """Decides slot migrations between a bucket's member groups.

    ``plan`` returns ``(moves, hold)``: moves to apply now (each validated
    again by ``migrate_slot_to``), and member names that should *skip*
    submitting their next segment this round — used to coordinate a common
    boundary.  The base policy never migrates.

    ``last_info`` carries the inputs behind the most recent plan (shares,
    active counts) so the scheduler decision journal can record *why* a
    move happened, not just that it did."""

    last_info: Dict[str, object] = {}

    def plan(self, members: Dict[str, object],
             weights: Dict[str, float]) -> Tuple[List[Move], Set[str]]:
        return [], set()


class RateBalancer(MigrationPolicy):
    """Opportunistic rebalancing for adaptive schedulers.

    When a member's active-slot count exceeds its weight-proportional
    share by at least one whole slot *and* it is at a segment boundary,
    one slot moves to the most under-share member that can accept it.  No
    member is ever held — migration happens only when the boundaries line
    up for free."""

    def plan(self, members, weights):
        names = list(members)
        if len(names) < 2:
            return [], set()
        active = {nm: _active(members[nm]) for nm in names}
        total = sum(active.values())
        if total == 0:
            return [], set()
        w = [max(0.0, float(weights.get(nm, 1.0))) for nm in names]
        tw = sum(w) or float(len(names))
        share = {nm: total * wi / tw for nm, wi in zip(names, w)}
        self.last_info = {"shares": {nm: round(share[nm], 3) for nm in names},
                          "active": dict(active)}
        srcs = sorted(
            (nm for nm in names
             if active[nm] - share[nm] >= 1.0 and members[nm].at_boundary()),
            key=lambda nm: (share[nm] - active[nm], nm))
        for s in srcs:
            grp = members[s]
            dsts = sorted(
                (nm for nm in names
                 if nm != s and share[nm] - active[nm] > 0.0),
                key=lambda nm: (active[nm] - share[nm], nm))
            for dname in dsts:
                dst = members[dname]
                for slot, req in enumerate(grp.slots):
                    if req is not None and \
                            dst.can_accept_migration(grp, slot):
                        return [(s, slot, dname)], set()
        return [], set()


class ForceMigrate(MigrationPolicy):
    """Deterministic migration exerciser for tests and CI smokes.

    Holds members that reach a segment boundary until *every* member is at
    one, then moves one slot from the busiest member to the first member
    that can accept it — a migration per coordinated boundary regardless
    of load skew, which is exactly what a bit-identity sweep needs."""

    def __init__(self) -> None:
        self.moves_planned = 0

    def plan(self, members, weights):
        names = list(members)
        if len(names) < 2:
            return [], set()
        busy = [nm for nm in names if _active(members[nm]) > 0]
        if not busy:
            return [], set()
        if not all(members[nm].at_boundary() for nm in names):
            return [], {nm for nm in names if members[nm].at_boundary()}
        src = max(busy, key=lambda nm: (_active(members[nm]), nm))
        grp = members[src]
        for dname in names:
            if dname == src:
                continue
            dst = members[dname]
            for slot, req in enumerate(grp.slots):
                if req is not None and dst.can_accept_migration(grp, slot):
                    self.moves_planned += 1
                    return [(src, slot, dname)], set()
        return [], set()
