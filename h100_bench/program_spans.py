"""The program's own spans and counters (the port's ``utils/profiling.py``),
recorded while the traced run's profiled rounds ran: what the per-layer
readers that count work inside a layer read. Each ``bo.suggest`` span is one
round. A program that keeps no span record gives None, and so does a record
that holds no round."""
from __future__ import annotations

import importlib

ROUND = "bo.suggest"
WAIT = "host.sync"


def record():
    """The program's spans in the order they opened, or None."""
    try:
        profiling = importlib.import_module(
            "gaussian_process_optimization_tpu_torch.utils.profiling")
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def rounds(rec) -> int:
    return sum(s.name == ROUND for s in rec or ())


def in_rounds(rec, name: str) -> list:
    """The spans named ``name`` that opened inside a round."""
    inside, out = [], []
    for s in rec or ():
        under = s.parent is not None and (rec[s.parent].name == ROUND or inside[s.parent])
        inside.append(under)
        if under and s.name == name:
            out.append(s)
    return out


def total(spans, counter: str) -> int:
    """A counter's increments summed over ``spans``."""
    return sum(s.counts.get(counter, 0) for s in spans)


def per_round(counter: str, layer: str):
    """``counter``'s increments inside the ``layer`` spans of the rounds, over
    the rounds; None without a round."""
    rec = record()
    n = rounds(rec)
    if not n:
        return None
    spans = [s for s in rec if s.name == ROUND] if layer == ROUND else in_rounds(rec, layer)
    return total(spans, counter) / n


def host_s(name: str):
    """Mean seconds of the ``name`` spans of the rounds less the ``host.sync``
    spans inside each: the host's own work in that layer; None without one."""
    rec = record()
    targets = {id(s) for s in in_rounds(rec, name)}
    if not targets:
        return None
    owner, own = [], {}  # the enclosing ``name`` span of each span, by index
    for i, s in enumerate(rec):
        mine = i if id(s) in targets else (None if s.parent is None else owner[s.parent])
        owner.append(mine)
        if mine == i:
            own[i] = s.end_ns - s.start_ns
        elif mine is not None and s.name == WAIT:
            own[mine] -= s.end_ns - s.start_ns
    return sum(own.values()) / len(own) / 1e9
