"""Prefix keys of the fleet's global prefix directory (the port's copy of
the JAX package's ``fleet/prefix_directory.py`` key functions).

A replica publishes the longest page-boundary key of every run its trie
inserts or adopts (``ServingEngine._publish_prefix``, carried by the
``ReplicaReporter``'s heartbeats); the router keys each request it routes
the same way and plans a pull hop (``POST /kv_fetch``) when a replica
other than its pick holds the prefix. A key is an incremental SHA-256 over
the page-sized token chunks of a prompt, seeded with the page size and the
adapter name, so every page boundary of a longer prompt yields the key a
shorter cached prefix published under. The keys must equal the JAX
package's for the same tokens and adapter: the router that matches them
is the JAX package's (``fleet/router.py``, framework-free), and its
``PrefixDirectory`` belongs to the router tier, not to a replica.

Stdlib only.
"""

from __future__ import annotations

import hashlib

_KEY_SEED = "tpukvf1"


def prefix_key_chain(tokens: list, page_tokens: int,
                     adapter: str = "") -> list[str]:
    """One key per FULL-page boundary of ``tokens``, shortest first:
    ``keys[i]`` covers pages ``0..i`` (``(i + 1) * page_tokens`` tokens).
    Incremental hashing means a prompt's chain contains, as a prefix, the
    chain of every shorter prompt it extends. The seed binds page size and
    adapter: a fleet re-paged at a different granule (or another adapter's
    pages) can never alias."""
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    h = hashlib.sha256(f"{_KEY_SEED}|{page_tokens}|{adapter}".encode())
    keys = []
    for start in range(0, len(tokens) - page_tokens + 1, page_tokens):
        chunk = tokens[start:start + page_tokens]
        h.update(",".join(str(int(t)) for t in chunk).encode())
        keys.append(h.copy().hexdigest()[:32])
    return keys


def prefix_key(tokens: list, page_tokens: int, adapter: str = "") -> str:
    """The longest-boundary key of ``tokens`` (what a holder publishes for
    an inserted run); "" when the run is shorter than one page."""
    chain = prefix_key_chain(tokens, page_tokens, adapter)
    return chain[-1] if chain else ""
