"""MPMD pipeline-parallel microbatch schedules for compiled graphs. A copy
of ``ray_tpu/dag/schedule.py``: the same programs, op for op.

Role parity: the static 1F1B / interleaved-1F1B schedules of "Scaling
Deep Learning Training with MPMD Pipeline Parallelism" (PAPERS.md) and
Megatron-LM's pipeline scheduler, re-targeted at the r11 compiled-graph
transport: each pipeline *partition* (a contiguous slice of transformer
layers) is hosted by a stage actor, activations/gradients travel through
cgraph channels, and every actor executes a STATIC, per-actor ordered
program of forward/backward ops once per training step.

The generator is an event-driven greedy list scheduler: each actor is a
serial executor; op readiness follows the pipeline dataflow
(``F(p, mb)`` needs ``F(p-1, mb)``; ``B(p, mb)`` needs ``F(p, mb)`` and
``B(p+1, mb)``); per-partition ops are issued in microbatch order. The
schedule *kind* is just the actor-local pick policy:

- ``gpipe``            — forwards strictly before backwards (fill/drain)
- ``1f1b``             — prefer a ready backward; cap in-flight
                         microbatches per partition at ``P - p`` so the
                         warmup depth matches classic 1F1B
- ``interleaved_1f1b`` — same policy over ``v`` layer *chunks* per actor
                         (virtual pipeline of ``P = s * v`` partitions,
                         partition ``p`` on actor ``p % s``), shrinking
                         the bubble by ``1/v``

Because per-partition microbatch order is monotone, every channel's
write order equals its read order — rings of a few slots are
deadlock-free under backpressure regardless of relative stage speeds.
``validate_programs`` re-checks that invariant plus executability
(deadlock-freedom) by replaying the programs against FIFO channels.
"""

from __future__ import annotations

from typing import List, NamedTuple

SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b")


class PipeOp(NamedTuple):
    """One scheduled unit of stage work: kind "F" (forward a microbatch
    through partition ``part``) or "B" (backward it)."""
    kind: str
    part: int
    mb: int


def partition_owner(part: int, num_stages: int) -> int:
    """Actor hosting a partition: round-robin (Megatron chunk placement),
    so chunk k of the virtual pipeline lands on actor ``part % s``."""
    return part % num_stages


def bubble_bound(num_microbatches: int, num_stages: int,
                 num_chunks: int = 1) -> float:
    """Analytic pipeline-efficiency upper bound m / (m + (s-1)/v): the
    fill+drain bubble costs (s-1)/v op-slots against m useful ones per
    stage (v = interleaving chunks; v=1 gives the classic m/(m+s-1))."""
    m, s, v = num_microbatches, num_stages, num_chunks
    if m < 1 or s < 1 or v < 1:
        raise ValueError("num_microbatches/num_stages/num_chunks must be >= 1")
    return m / (m + (s - 1) / v)


def stage_programs(kind: str, num_stages: int, num_microbatches: int,
                   num_chunks: int = 1, fwd_cost: float = 1.0,
                   bwd_cost: float = 2.0) -> List[List[PipeOp]]:
    """Compile the per-actor op programs for one training step.

    Returns ``programs[a]`` = ordered [PipeOp] for actor ``a``. The cost
    arguments only shape tie-breaking in the greedy simulation (bwd ~ 2x
    fwd for recompute-based backward); correctness never depends on them
    because channel backpressure enforces the true dataflow at runtime.
    """
    s, m, v = num_stages, num_microbatches, num_chunks
    if kind not in SCHEDULES:
        raise ValueError(f"unknown schedule kind {kind!r} (one of {SCHEDULES})")
    if s < 1 or m < 1 or v < 1:
        raise ValueError("num_stages/num_microbatches/num_chunks must be >= 1")
    if kind != "interleaved_1f1b" and v != 1:
        raise ValueError(f"schedule {kind!r} requires num_chunks=1 (got {v})")
    P = s * v
    prefer_bwd = kind != "gpipe"

    fin_f: dict = {}            # (part, mb) -> finish time
    fin_b: dict = {}
    fnext = [0] * P             # next microbatch to forward, per partition
    bnext = [0] * P
    clock = [0.0] * s           # per-actor busy-until time
    programs: List[List[PipeOp]] = [[] for _ in range(s)]
    # In-flight cap per partition: deeper partitions hold fewer stashed
    # microbatches; this is what turns greedy into 1F1B (warmup depth
    # P - p) instead of GPipe-style run-ahead.
    cap = [P - p for p in range(P)]
    remaining = 2 * P * m

    def candidates(a: int):
        out = []
        for p in range(a, P, s):
            mb = fnext[p]
            if mb < m and (not prefer_bwd or fnext[p] - bnext[p] < cap[p]):
                ready = 0.0 if p == 0 else fin_f.get((p - 1, mb))
                if ready is not None:
                    out.append(("F", p, mb, max(clock[a], ready)))
            mb = bnext[p]
            if mb < m and mb < fnext[p]:
                fw = fin_f.get((p, mb))
                up = 0.0 if p == P - 1 else fin_b.get((p + 1, mb))
                if fw is not None and up is not None:
                    out.append(("B", p, mb, max(clock[a], max(fw, up))))
        return out

    def pick(cands):
        # gpipe: forwards categorically first; 1f1b: earliest start wins,
        # backward preferred on ties (drain stashed state eagerly).
        if prefer_bwd:
            key = lambda c: (c[3], 0 if c[0] == "B" else 1, c[2], c[1])
        else:
            key = lambda c: (0 if c[0] == "F" else 1, c[3], c[2], c[1])
        return min(cands, key=key)

    while remaining:
        best = None
        for a in range(s):
            cands = candidates(a)
            if not cands:
                continue
            choice = pick(cands)
            if best is None or (choice[3], a) < (best[0][3], best[1]):
                best = (choice, a)
        if best is None:
            raise RuntimeError(
                f"schedule deadlock: {remaining} ops unscheduled "
                f"(kind={kind}, s={s}, m={m}, v={v})")
        (k, p, mb, start), a = best
        finish = start + (fwd_cost if k == "F" else bwd_cost)
        clock[a] = finish
        programs[a].append(PipeOp(k, p, mb))
        if k == "F":
            fin_f[(p, mb)] = finish
            fnext[p] = mb + 1
        else:
            fin_b[(p, mb)] = finish
            bnext[p] = mb + 1
        remaining -= 1
    return programs


def validate_programs(programs: List[List[PipeOp]], num_stages: int,
                      num_microbatches: int, num_chunks: int = 1) -> None:
    """Assert a program set is complete, channel-ordered, and deadlock-
    free. Raises ValueError on any violation."""
    s, m, v = num_stages, num_microbatches, num_chunks
    P = s * v
    seen = set()
    order = [[0, 0] for _ in range(P)]    # per-partition next [F, B] mb
    for a, prog in enumerate(programs):
        fdone = set()
        for op in prog:
            if partition_owner(op.part, s) != a:
                raise ValueError(f"op {op} scheduled on wrong actor {a}")
            if op in seen:
                raise ValueError(f"duplicate op {op}")
            seen.add(op)
            if not 0 <= op.part < P:
                raise ValueError(
                    f"{op} references partition outside [0, {P}) — "
                    f"num_stages/num_chunks mismatch with the programs")
            idx = 0 if op.kind == "F" else 1
            if op.mb != order[op.part][idx]:
                raise ValueError(
                    f"{op} out of microbatch order (expected mb "
                    f"{order[op.part][idx]}) — channel FIFO would deadlock")
            order[op.part][idx] = op.mb + 1
            if op.kind == "F":
                fdone.add((op.part, op.mb))
            elif (op.part, op.mb) not in fdone:
                raise ValueError(f"{op} scheduled before its forward")
    if len(seen) != 2 * P * m:
        raise ValueError(f"incomplete schedule: {len(seen)} != {2 * P * m} ops")

    # Replay against FIFO dataflow: an op at an actor's program counter
    # runs iff its cross-actor inputs have been produced.
    pc = [0] * len(programs)
    done = set()
    total = sum(len(p) for p in programs)
    ran = 0
    while ran < total:
        progressed = False
        for a, prog in enumerate(programs):
            while pc[a] < len(prog):
                op = prog[pc[a]]
                if op.kind == "F":
                    ok = op.part == 0 or ("F", op.part - 1, op.mb) in done
                else:
                    ok = (("F", op.part, op.mb) in done and
                          (op.part == P - 1 or
                           ("B", op.part + 1, op.mb) in done))
                if not ok:
                    break
                done.add((op.kind, op.part, op.mb))
                pc[a] += 1
                ran += 1
                progressed = True
        if not progressed:
            stuck = [programs[a][pc[a]] for a in range(len(programs))
                     if pc[a] < len(programs[a])]
            raise ValueError(f"schedule not executable; stuck at {stuck}")
