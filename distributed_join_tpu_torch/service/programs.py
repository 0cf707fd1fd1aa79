"""Content digests of JSON-ish specs.

Port of ``_canon`` (:68) and ``spec_digest`` (:82) of
``distributed_join_tpu/service/programs.py``, the canonicalizer that the
program cache's signatures and a query plan's digest share: the same
document gives the same digest in both packages. The program cache
itself (``JoinProgramCache``, ``JoinSignature``) is not part of the
port.
"""

from __future__ import annotations

import hashlib
import json


def _canon(v):
    """Hashable, JSON-stable form of one option value."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return tuple(sorted((str(k), _canon(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    # flat frozen dataclasses: their repr tells values apart
    return repr(v)


def spec_digest(doc) -> str:
    """Stable content digest (sha256 hex) of a JSON-ish document
    (dicts, lists, scalars), through :func:`_canon`."""
    canon = _canon(doc)
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True, default=str).encode()
    ).hexdigest()
