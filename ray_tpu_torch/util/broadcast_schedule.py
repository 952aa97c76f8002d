"""The host-level broadcast schedule of ``parallel/collectives.py``
(``broadcast_rounds``), in a module of its own that imports no torch: the
object plane's broadcast tree runs it in control-plane processes, which
load no torch."""

from __future__ import annotations


def broadcast_rounds(n: int, *, fanout: int = 2, root: int = 0):
    """Host-level broadcast schedule: rounds of (src, dst) legs spreading
    one copy from ``root`` to all ``n`` members, each holder re-sending to
    up to ``fanout`` new members per round (binomial tree at fanout=2, so
    ceil(log2 n) rounds). Pure schedule; legs inside a round are
    independent."""
    if n <= 0:
        return []
    if fanout < 1:
        fanout = 1
    have = [root % n]
    pending = [i for i in range(n) if i != root % n]
    rounds = []
    while pending:
        legs = []
        senders = list(have)
        for src in senders:
            for _ in range(fanout):
                if not pending:
                    break
                dst = pending.pop(0)
                legs.append((src, dst))
                have.append(dst)
        rounds.append(legs)
    return rounds
