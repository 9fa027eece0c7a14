"""Multi-group serving: placement math and the migration policy interface.

A copy of the parts of the JAX package's ``serve/multigroup.py`` that the
server calls when it serves on one DeviceGroup: :func:`proportional_split`
(decode slots per group) and the base :class:`MigrationPolicy` (which never
migrates).  Wave placement across groups (``plan_wave``) and the
rebalancing policies (``RateBalancer``, ``ForceMigrate``) come with
multi-group serving (ROADMAP.md item A7).
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
