"""Placement groups: bundle reservation over cluster nodes (the port's
copy of ``raydp_tpu/cluster/placement.py``).

Capability parity with Ray placement groups as used by the reference
(reference: python/raydp/context.py:94-110 builds the group;
core/.../RayAppMaster.scala:281-289 round-robins executors over bundle
indexes). Strategies:

  * PACK         — prefer few nodes, best-effort
  * STRICT_PACK  — all bundles on one node, else error
  * SPREAD       — prefer distinct nodes, best-effort round-robin
  * STRICT_SPREAD— all bundles on distinct nodes, else error

Nodes are hosts; on a single machine, tests exercise multi-node
logic via virtual nodes (``RAYDP_TPU_VIRTUAL_NODES``).
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from raydp_tpu_torch.utils.net import local_ip


@dataclass
class NodeInfo:
    node_id: str
    address: str
    resources: Dict[str, float]  # {"cpu": n, "memory": bytes, ...}

    def copy(self) -> "NodeInfo":
        return NodeInfo(self.node_id, self.address, dict(self.resources))


def detect_nodes(num_virtual: Optional[int] = None) -> List[NodeInfo]:
    """Discover cluster nodes. Single-host: one node with this host's CPUs
    and memory (``os.cpu_count`` and ``sysconf``, where the reference asks
    psutil, which the port does not depend on),
    or N equal virtual nodes when requested (``num_virtual`` argument or
    RAYDP_TPU_VIRTUAL_NODES env — tests and local multi-node simulation;
    the reference similarly simulates multi-node with multiple JVMs on one
    host, SURVEY §4)."""
    # Logical-resource override, like `ray start --num-cpus N` (the
    # reference CI boots its head node that way, raydp.yml:103-106).
    cpus = float(
        os.environ.get("RAYDP_TPU_NUM_CPUS") or (os.cpu_count() or 1)
    )
    mem = float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    n_virtual = (
        num_virtual
        if num_virtual is not None
        else int(os.environ.get("RAYDP_TPU_VIRTUAL_NODES", "0"))
    )
    ip = local_ip()
    if n_virtual <= 1:
        return [NodeInfo("node-0", ip, {"cpu": cpus, "memory": mem})]
    return [
        NodeInfo(
            f"node-{i}",
            ip,
            {"cpu": cpus / n_virtual, "memory": mem / n_virtual},
        )
        for i in range(n_virtual)
    ]


@dataclass
class Bundle:
    """One resource reservation; placed on exactly one node."""

    resources: Dict[str, float]
    node_id: Optional[str] = None  # assigned at placement time


class PlacementError(RuntimeError):
    pass


@dataclass
class PlacementGroup:
    bundles: List[Bundle]
    strategy: str
    group_id: str = field(
        default_factory=lambda: f"pg-{next(_pg_counter)}"
    )

    @property
    def bundle_node_ids(self) -> List[Optional[str]]:
        return [b.node_id for b in self.bundles]


_pg_counter = itertools.count()


def _fits(avail: Dict[str, float], need: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in need.items())


def _reserve(avail: Dict[str, float], need: Dict[str, float]) -> None:
    for k, v in need.items():
        avail[k] = avail.get(k, 0.0) - v


def place(
    bundles: List[Dict[str, float]],
    strategy: str,
    nodes: List[NodeInfo],
) -> PlacementGroup:
    """Assign each bundle a node per the strategy, or raise PlacementError."""
    if not bundles:
        raise PlacementError("placement group needs at least one bundle")
    group = PlacementGroup([Bundle(dict(b)) for b in bundles], strategy)
    avail = {n.node_id: dict(n.resources) for n in nodes}
    order = [n.node_id for n in nodes]

    if strategy in ("PACK", "STRICT_PACK"):
        # Find one node that holds all bundles.
        for node_id in order:
            trial = dict(avail[node_id])
            ok = True
            for b in group.bundles:
                if _fits(trial, b.resources):
                    _reserve(trial, b.resources)
                else:
                    ok = False
                    break
            if ok:
                for b in group.bundles:
                    b.node_id = node_id
                return group
        if strategy == "STRICT_PACK":
            raise PlacementError(
                f"STRICT_PACK: no single node fits {len(group.bundles)} bundles"
            )
        # PACK fallback: greedy first-fit across nodes.
        return _first_fit(group, avail, order)

    if strategy in ("SPREAD", "STRICT_SPREAD"):
        used_nodes = set()
        for b in group.bundles:
            chosen = None
            for node_id in order:
                if node_id in used_nodes:
                    continue
                if _fits(avail[node_id], b.resources):
                    chosen = node_id
                    break
            if chosen is None:
                if strategy == "STRICT_SPREAD":
                    raise PlacementError(
                        "STRICT_SPREAD: not enough distinct nodes "
                        f"({len(nodes)} nodes, {len(group.bundles)} bundles)"
                    )
                # SPREAD best-effort: reuse the least-loaded fitting node
                # (most remaining cpu) so overflow stays balanced.
                fitting = [
                    node_id for node_id in order
                    if _fits(avail[node_id], b.resources)
                ]
                if not fitting:
                    raise PlacementError("SPREAD: no node fits bundle")
                chosen = max(fitting, key=lambda nid: avail[nid].get("cpu", 0.0))
            _reserve(avail[chosen], b.resources)
            used_nodes.add(chosen)
            b.node_id = chosen
        return group

    raise PlacementError(f"unknown strategy {strategy!r}")


def _first_fit(
    group: PlacementGroup, avail: Dict[str, Dict[str, float]], order: List[str]
) -> PlacementGroup:
    for b in group.bundles:
        for node_id in order:
            if _fits(avail[node_id], b.resources):
                _reserve(avail[node_id], b.resources)
                b.node_id = node_id
                break
        else:
            raise PlacementError("PACK: no node fits bundle")
    return group
