"""The port's ``dryrun_multichip`` as gloo groups of 4 and 8 processes,
and its copy of the multislice bootstrap against the reference's.

- ``dryrun_multichip(4)`` and ``(8)`` run on every rank of a group
  started by ``entry.main([n, "--backend", "gloo"])`` (the module's
  command line; without the flag it takes the cards); each rank's
  summary line must have the reference's parts in order with the
  numbers masked: the pattern is read from the f-strings of
  ``__graft_entry__.py`` (its final ``print``, and the notes it
  builds), so the port's line is held to the reference's text; the
  collectives' note is held up to its per-hop time, whose unit names
  the backend in the port. At 4 ranks the multislice part runs and the
  ZeRO-1 part reports its skip; at 8 both run.
- ``live_cliques`` and ``multislice_env`` of both packages on the same
  clique dicts, served by the port's in-memory ``CliqueStore``: the
  same cliques and env, or the same ``MultisliceIncomplete`` message
  (too few live cliques, empty shells and unindexed members ignored,
  another CD's cliques and another namespace's ignored, an own clique
  outside the canonical set, a coordinator not joined yet).
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from tpu_dra_driver_torch import entry
from tpu_dra_driver_torch.computedomain import multislice as tms

REPO = Path(__file__).resolve().parents[1]
NOTES = ("z_assert", "ms_note", "coll_note")


def _pattern(node: ast.JoinedStr) -> str:
    """The f-string as a regex: its text literally, each field as a lazy
    group."""
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(re.escape(v.value))
        else:
            parts.append("(.*?)")
    return "".join(parts)


def _reference_patterns():
    """The reference dryrun's final line and each of its notes' texts,
    as regexes, from the source of ``__graft_entry__.py``."""
    tree = ast.parse((REPO / "__graft_entry__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    line, notes = None, {k: [] for k in NOTES}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "print":
            line = _pattern(node.args[0])
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                names = [t.id for t in getattr(target, "elts", [target])
                         if isinstance(t, ast.Name)]
                values = getattr(node.value, "elts", [node.value])
                for name, value in zip(names, values):
                    if name in NOTES and isinstance(value, (ast.JoinedStr,
                                                            ast.Constant)):
                        notes[name].append(
                            _pattern(value) if isinstance(value,
                                                          ast.JoinedStr)
                            else re.escape(value.value))
    return line, notes


@pytest.fixture(scope="module", params=[4, 8])
def lines(request):
    n = request.param
    return n, entry.main([str(n), "--backend", "gloo"])


def test_dryrun_line_has_the_references_parts_in_order(lines):
    n, got = lines
    line_re, notes = _reference_patterns()
    assert line_re is not None and all(notes.values())
    # every rank's line is the same up to its own per-hop time
    assert len({re.sub(r"\(\d+ us/hop", "", x) for x in got}) == 1, got
    m = re.fullmatch(line_re, got[0])
    assert m, got[0]
    fields = dict(zip(("n", "dp", "sp", "tp", "ep", "lv", "zlv", "z_assert",
                       "n_stages", "plv", "d_dp", "d_tp", "s2_dp", "s2_tp",
                       "ms_note", "coll_note"), m.groups()))
    assert fields["n"] == str(n)
    for name in ("z_assert", "ms_note"):
        assert any(re.fullmatch(p, fields[name]) for p in notes[name]), \
            (name, fields[name])
    head = [p.split(re.escape(" us/hop"))[0] for p in notes["coll_note"]]
    assert any(re.match(p, fields["coll_note"]) for p in head), \
        fields["coll_note"]
    if n == 4:
        assert fields["z_assert"] == "skipped (n_devices < 8)"
        assert fields["ms_note"].startswith("2-slice multislice OK")
    else:
        assert "moment leaves dp-sharded" in fields["z_assert"]
        assert float(fields["zlv"]) > 0
    assert float(fields["lv"]) > 0 and float(fields["plv"]) > 0


def test_main_takes_the_cards_unless_asked_for_gloo(monkeypatch):
    """``python -m tpu_dra_driver_torch.entry N`` runs over NCCL, one
    card a rank; with no card it raises and names the flag."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --backend gloo"):
        entry.main(["2"])


def test_dryrun_needs_a_group_of_n():
    with pytest.raises(RuntimeError, match="process group has 0 ranks"):
        entry.dryrun_multichip(4, device="cpu")


def _clique(cd, cid, daemons, namespace=tms.DRIVER_NAMESPACE):
    return {"apiVersion": "resource.tpu.google.com/v1beta1",
            "kind": "ComputeDomainClique",
            "metadata": {"name": f"{cd}.{cid}", "namespace": namespace},
            "daemons": daemons}


def _workers(s, n=2, first=0, ip=True):
    return [{"nodeName": f"host-{s}-{w}",
             "ipAddress": f"10.{s}.0.{w + 2}" if ip else "",
             "index": w, "status": "Ready"} for w in range(first, n)]


CLIQUE_SETS = {
    "two-slices": [_clique("cd", "slice-1", _workers(1)),
                   _clique("cd", "slice-0", _workers(0))],
    "empty-shells": [_clique("cd", "a-gone", []),
                     _clique("cd", "b-unindexed", [dict(_workers(5)[0],
                                                        index=-1)]),
                     _clique("cd", "slice-0", _workers(0)),
                     _clique("cd", "slice-1", _workers(1))],
    "too-few": [_clique("cd", "slice-0", _workers(0)),
                _clique("cd", "slice-1", [])],
    "three-live": [_clique("cd", "slice-2", _workers(2)),
                   _clique("cd", "slice-0", _workers(0)),
                   _clique("cd", "slice-1", _workers(1))],
    "others-ignored": [_clique("other", "slice-0", _workers(7)),
                       _clique("cd", "slice-0", _workers(0), "elsewhere"),
                       _clique("cd", "slice-0", _workers(0)),
                       _clique("cd", "slice-1", _workers(1))],
    "no-coordinator": [_clique("cd", "slice-0", _workers(0, first=1)),
                       _clique("cd", "slice-1", _workers(1))],
    "coordinator-without-ip": [_clique("cd", "slice-0", _workers(0, ip=False)),
                               _clique("cd", "slice-1", _workers(1))],
}
OWN = ("slice-0", "slice-1", "slice-2")


def _outcome(module, store, own):
    try:
        return ("env", module.multislice_env(store, "cd", 2, own))
    except module.MultisliceIncomplete as e:
        return ("incomplete", str(e))


@pytest.mark.parametrize("name", list(CLIQUE_SETS))
def test_multislice_matches_the_reference(name):
    from tpu_dra_driver.computedomain import multislice as jms
    store = tms.CliqueStore()
    for obj in CLIQUE_SETS[name]:
        store.create(obj)
    assert tms.live_cliques(store, "cd") == jms.live_cliques(store, "cd")
    outcomes = {own: _outcome(tms, store, own) for own in OWN}
    assert outcomes == {own: _outcome(jms, store, own) for own in OWN}
    kinds = {kind for kind, _ in outcomes.values()}
    if name in ("too-few", "no-coordinator", "coordinator-without-ip"):
        assert kinds == {"incomplete"}
    else:
        assert outcomes["slice-1"][1]["MEGASCALE_SLICE_ID"] == "1"
        assert outcomes["slice-2"][0] == "incomplete"


def test_multislice_constants_match_the_reference():
    from tpu_dra_driver.computedomain import DRIVER_NAMESPACE
    from tpu_dra_driver.computedomain import multislice as jms
    assert tms.MEGASCALE_PORT == jms.MEGASCALE_PORT
    assert tms.DRIVER_NAMESPACE == DRIVER_NAMESPACE
