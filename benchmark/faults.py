"""Faults planted in the program under test, each of which the check has
to catch (`correct` false): the tests plant them at test size on the CPU,
and control.py at a cell's own size on the card.

* unchanged_commit — the wave engine's commit leaves its state as it was:
  each engine step of a wave sees the wave's start;
* unchanged_snapshot — the resident snapshot's patch returns its planes
  unchanged: each wave sees the state of the last full snapshot;
* half_batch — every other pod of a wave is left out (its answer dropped);
* one_answer — one placed pod a wave is sent to another node.
"""

from __future__ import annotations

import contextlib


def _patch(obj, name, value, undo):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _result(undo, fn):
    import kubernetes_tpu_torch.sched.scheduler as S

    orig = S.schedule_batch

    def wrapped(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(node=fn(res.node))

    _patch(S, "schedule_batch", wrapped, undo)


def _unchanged_commit(undo):
    import torch

    import kubernetes_tpu_torch.ops.waves as W

    _patch(W, "exact_int_matmul", lambda a, b: torch.zeros(
        (a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device), undo)


def _unchanged_snapshot(undo):
    import kubernetes_tpu_torch.state.cache as C

    _patch(C, "_patch_rows", lambda tree, idx, rows: tree, undo)


def _half_batch(undo):
    def halve(node):
        node = node.clone()
        node[1::2] = -1
        return node

    _result(undo, halve)


def _one_answer(undo):
    def alter(node):
        node = node.clone()
        placed = (node >= 0).nonzero()
        if len(placed):
            i = int(placed[0])
            node[i] = 1 if int(node[i]) == 0 else 0
        return node

    _result(undo, alter)


FAULTS = {"unchanged_commit": _unchanged_commit,
          "unchanged_snapshot": _unchanged_snapshot,
          "half_batch": _half_batch, "one_answer": _one_answer}


@contextlib.contextmanager
def planted(name: str):
    """Plant the fault `name` for the block's length."""
    undo = []
    try:
        FAULTS[name](undo)
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
