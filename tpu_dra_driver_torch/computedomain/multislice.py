"""Multislice (DCN) bootstrap derivation from a ComputeDomain's cliques.

The port's own copy of :mod:`tpu_dra_driver.computedomain.multislice`
(``live_cliques``, ``multislice_env``, ``MEGASCALE_PORT``,
``MultisliceIncomplete``), over clique objects as plain dicts, as the
control plane stores them (``metadata.name`` is ``<cdUID>.<cliqueID>``;
``daemons`` lists ``nodeName``, ``ipAddress``, ``index``, ``status``).
Every node derives the same facts with no extra coordination:

- slice ordering: lexicographic over the *live* cliques' names;
- the coordinator: slice 0's index-0 worker.

"Live" excludes empty cliques: a departed slice leaves its clique object
behind with no indexed members, and counting such shells would wedge
the coordinator lookup or shift slice ids.

:class:`CliqueStore` is a minimal in-memory clique client (``create``,
``list``), the part of the control plane's clients that the derivation
reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_dra_driver_torch.computedomain import DRIVER_NAMESPACE

# DCN rendezvous port the megascale transport listens on.
MEGASCALE_PORT = 8080


class MultisliceIncomplete(Exception):
    """The cross-slice world cannot be derived yet: transient; callers
    gating workload release map this to their retry mechanism."""


class CliqueStore:
    """ComputeDomainClique objects in memory: ``create`` stores a copy
    of an object (its ``metadata.namespace`` defaults to the DRA driver's)
    and returns it; ``list`` returns those of a namespace (every one
    without one), in creation order."""

    def __init__(self):
        self._objs: List[Dict] = []

    def create(self, obj: Dict) -> Dict:
        meta = dict(obj.get("metadata") or {})
        meta.setdefault("namespace", DRIVER_NAMESPACE)
        name = (meta.get("namespace"), meta.get("name"))
        if any((o["metadata"]["namespace"], o["metadata"].get("name"))
               == name for o in self._objs):
            raise ValueError(f"clique {name[1]!r} already exists in "
                             f"{name[0]!r}")
        stored = dict(obj, metadata=meta)
        self._objs.append(stored)
        return stored

    def list(self, namespace: Optional[str] = None) -> List[Dict]:
        return [o for o in self._objs
                if namespace is None
                or o["metadata"]["namespace"] == namespace]


def live_cliques(cliques_client, cd_uid: str) -> List[Dict]:
    """The CD's cliques that have at least one indexed member, in slice
    order (lexicographic by clique name)."""
    prefix = f"{cd_uid}."
    out = [o for o in cliques_client.list(namespace=DRIVER_NAMESPACE)
           if o["metadata"]["name"].startswith(prefix)
           and any((d.get("index", -1)) >= 0 for d in o.get("daemons") or [])]
    out.sort(key=lambda o: o["metadata"]["name"])
    return out


def multislice_env(cliques_client, cd_uid: str, num_slices: int,
                   own_clique_id: str) -> Dict[str, str]:
    """MEGASCALE_* env for one worker, or raises MultisliceIncomplete.

    With more live cliques than numSlices (should not persist: the
    controller prunes dead members and empty shells are ignored), the
    first numSlices in slice order are canonical; a node whose clique
    is outside that set is not releasable.
    """
    cliques = live_cliques(cliques_client, cd_uid)
    if len(cliques) < num_slices:
        raise MultisliceIncomplete(
            f"{len(cliques)}/{num_slices} slices have formed cliques")
    prefix = f"{cd_uid}."
    clique_ids = [o["metadata"]["name"][len(prefix):]
                  for o in cliques[:num_slices]]
    if own_clique_id not in clique_ids:
        raise MultisliceIncomplete(
            f"own clique {own_clique_id!r} not among the {num_slices} "
            f"canonical slices {clique_ids}")
    c0 = next((d for d in cliques[0].get("daemons") or []
               if d.get("index", -1) == 0 and d.get("ipAddress", "")),
              None)
    if c0 is None:
        raise MultisliceIncomplete(
            "coordinator (slice 0 worker 0) not joined yet")
    return {
        "MEGASCALE_NUM_SLICES": str(num_slices),
        "MEGASCALE_SLICE_ID": str(clique_ids.index(own_clique_id)),
        "MEGASCALE_COORDINATOR_ADDRESS": f"{c0['ipAddress']}:{MEGASCALE_PORT}",
        "MEGASCALE_PORT": str(MEGASCALE_PORT),
    }
