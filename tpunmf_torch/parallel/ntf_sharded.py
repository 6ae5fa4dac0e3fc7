"""Sharded N-way CP: not ported yet (ROADMAP.md, queue 1, item 9)."""
from __future__ import annotations


def ntf_sharded(*args, **kwargs):
    """``tpunmf.parallel.ntf_sharded``'s place; raises until it is ported."""
    raise NotImplementedError(
        "ntf_sharded: sharded N-way CP is not ported yet (ROADMAP.md, queue 1, item 9)")
