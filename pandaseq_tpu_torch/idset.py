"""PandaSet equivalent (idset.c): a set of sequence identifiers.

The reference implements a move-to-front binary search tree keyed by
panda_seqid_compare (idset.c:91-122); a hash set of the canonical id
string provides the same membership semantics (panda_seqid_equal
compares every field, which the canonical print form captures
one-to-one).

The PyTorch port's copy of ``pandaseq_tpu/idset.py``, unchanged but for its
imports; the port imports nothing of ``pandaseq_tpu``.
"""

from __future__ import annotations

from . import seqid as seqid_mod


class IdSet:
    """panda_idset_* surface (pandaseq-set.h)."""

    def __init__(self):
        self._set = set()

    def add(self, sid) -> None:
        """panda_idset_add."""
        self._set.add(str(sid))

    def add_str(self, header: str,
                policy: str = seqid_mod.TAG_OPTIONAL) -> bool:
        """panda_idset_add_str: parse then add; False on parse failure."""
        s = header[1:] if header.startswith("@") else header
        direction, sid, _ = seqid_mod.parse(s, policy)
        if direction == 0:
            return False
        self._set.add(str(sid))
        return True

    def contains(self, sid) -> bool:
        """panda_idset_contains."""
        return str(sid) in self._set

    def __contains__(self, sid) -> bool:
        return self.contains(sid)

    def __len__(self) -> int:
        return len(self._set)
