"""Elastic group management for a live ``InferenceServer``.

Port of the JAX package's ``distributed/elastic.py``, its serving half:
:class:`ElasticServeGroups` lets a DeviceGroup join a live server or drain
from it (its decode slots migrate to the surviving groups at segment
boundaries) without dropping a request.  On one card the groups are CUDA
streams of it.

The training half of the reference, ``plan_remesh`` (the largest valid
mesh from the surviving devices) and ``ElasticRunner`` (rebuild on the
survivors from the latest checkpoint, ``ckpt/checkpoint.py``), needs the
device mesh (ROADMAP.md item A11), and comes with it.
"""
from __future__ import annotations


class ElasticServeGroups:
    """Elastic group management for a live ``InferenceServer``.

    The serving analogue of the reference's ``ElasticRunner``: instead of rebuilding a
    mesh from survivors and restoring a checkpoint, the server's
    ``group_batches`` regime lets a DeviceGroup *join* (fresh per-group
    block pool, immediately eligible for wave placement) or *drain* (its
    decode slots migrate to surviving groups at segment boundaries) without
    dropping in-flight requests — host mirrors are authoritative at
    boundaries, so no checkpoint round-trip is needed.
    """

    def __init__(self, server) -> None:
        self.server = server

    def join(self, group) -> None:
        """Scale up: add ``group`` to the live server (or un-drain it)."""
        self.server.join_group(group)

    def drain(self, name: str) -> None:
        """Scale down: stop placing work on ``name``; active slots migrate
        off at their next segment boundary and the member dissolves."""
        self.server.drain_group(name)

    def on_failure(self, lost_name: str) -> None:
        """Pod is going away: drain it so in-flight decode state moves to
        the survivors through the O(blocks) migration path."""
        self.server.drain_group(lost_name)
