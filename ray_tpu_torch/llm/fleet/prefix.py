"""Prefix index + per-replica KV prefix cache for the serving fleet (a
copy of ray_tpu/llm/fleet/prefix.py).

Reference analog: the radix-tree prefix cache SGLang/vLLM decode
replicas keep, summarized for the router the way production
prefix-affinity routers (e.g. the reference's serve request router
plugins) consume it: the router never walks a remote radix tree — each
replica publishes a compact *digest* of what it holds and the router
scores candidate replicas by longest shared prompt prefix.

Two pieces:

* :func:`prefix_chain` — cumulative block hashes of a token sequence
  (one 8-byte digest per ``block`` tokens).  Because the hashes are
  cumulative, "longest shared prefix" against a replica's published
  digest set is just "count of leading chain entries present in the
  set" — O(blocks) set lookups, no token comparison on the hot path.
* :class:`PrefixCache` — a byte-bounded LRU of full-prompt
  :class:`~ray_tpu_torch.llm.disagg.KVHandoff` entries a decode replica
  retains after import.  A *full hit* (exact prompt already resident)
  replays the cached handoff into the local engine and skips the
  prefill tier entirely; partial chain overlap only steers routing.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

#: Tokens per hash block.  Matches the engine's default KV page size so
#: a chain entry corresponds to whole cached pages.
DEFAULT_BLOCK = 16


def _digest(h) -> str:
    return h.hexdigest()


def prefix_chain(tokens: Sequence[int], block: int = DEFAULT_BLOCK
                 ) -> List[str]:
    """Cumulative digests at each full ``block`` boundary of ``tokens``.

    ``chain[i]`` identifies ``tokens[:(i+1)*block]``; a shorter prompt's
    chain is a strict prefix of a longer one's, which is what makes set
    membership equivalent to shared-prefix length."""
    out: List[str] = []
    h = hashlib.blake2b(digest_size=8)
    n = (len(tokens) // block) * block
    for i in range(0, n, block):
        h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                          for t in tokens[i:i + block]))
        out.append(_digest(h.copy()))
    return out


def full_hash(tokens: Sequence[int]) -> str:
    """Exact-prompt digest (length-delimited, so a prompt and its
    padding-extended sibling never collide)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(len(tokens).to_bytes(4, "little"))
    h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                      for t in tokens))
    return _digest(h)


class PrefixCache:
    """Byte-bounded LRU over full-prompt KV handoffs, per decode replica.

    Entries are the replica's own copies of imported handoffs (on the
    card, in device memory), bounded by ``capacity_bytes`` of K/V.  ``summary()`` is the router-facing
    digest: the block-chain set for affinity scoring plus the
    full-prompt set for hit detection, stamped with a version so the
    router can cache it between mutations.
    """

    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024,
                 block: int = DEFAULT_BLOCK):
        self.capacity_bytes = int(capacity_bytes)
        self.block = block
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._bytes: Dict[str, int] = {}
        self._chains: Dict[str, List[str]] = {}
        #: chain digest -> refcount (several cached prompts share leading
        #: blocks; the digest stays scoreable until the last one goes).
        self._blocks: Dict[str, int] = {}
        self._used = 0
        self._version = 0
        self.hits = 0
        self.misses = 0

    # -- writes ------------------------------------------------------------

    def insert(self, handoff) -> bool:
        """Retain one imported handoff (keyed by exact prompt).  Entries
        larger than the whole cache are refused; the LRU tail is evicted
        until the new entry fits."""
        key = full_hash(handoff.prompt_tokens)
        nbytes = int(handoff.nbytes)
        if nbytes > self.capacity_bytes:
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            while self._used + nbytes > self.capacity_bytes \
                    and self._entries:
                self._evict_tail_locked()
            self._entries[key] = handoff
            self._bytes[key] = nbytes
            chain = prefix_chain(handoff.prompt_tokens, self.block)
            self._chains[key] = chain
            for d in chain:
                self._blocks[d] = self._blocks.get(d, 0) + 1
            self._used += nbytes
            self._version += 1
        return True

    def _evict_tail_locked(self) -> None:
        key, _h = self._entries.popitem(last=False)
        self._used -= self._bytes.pop(key, 0)
        for d in self._chains.pop(key, ()):  # drop chain refcounts
            left = self._blocks.get(d, 1) - 1
            if left <= 0:
                self._blocks.pop(d, None)
            else:
                self._blocks[d] = left
        self._version += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self._chains.clear()
            self._blocks.clear()
            self._used = 0
            self._version += 1

    # -- reads -------------------------------------------------------------

    def lookup(self, prompt_tokens: Sequence[int]):
        """The cached handoff for this EXACT prompt, or None.  Verifies
        token equality (an 8-byte digest collision must degrade to a
        miss, never to wrong KV)."""
        key = full_hash(prompt_tokens)
        with self._lock:
            h = self._entries.get(key)
            if h is None or list(h.prompt_tokens) != list(prompt_tokens):
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return h

    def match_blocks(self, chain: Sequence[str]) -> int:
        """Longest shared prefix, in blocks, between ``chain`` and any
        cached prompt (leading-run membership of cumulative digests)."""
        n = 0
        with self._lock:
            for d in chain:
                if d not in self._blocks:
                    break
                n += 1
        return n

    def summary(self) -> Dict[str, Any]:
        """Router-facing digest snapshot (cheap to ship cross-process)."""
        with self._lock:
            return {
                "version": self._version,
                "entries": len(self._entries),
                "bytes": self._used,
                "capacity_bytes": self.capacity_bytes,
                "block": self.block,
                "blocks": set(self._blocks),
                "full": set(self._entries),
                "hits": self.hits,
                "misses": self.misses,
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._entries), "bytes": self._used,
                    "capacity_bytes": self.capacity_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": (self.hits / total) if total else None}


def score_summary(summary: Optional[Dict[str, Any]], chain: Sequence[str],
                  fh: str) -> tuple:
    """Score one replica's published digest against a request:
    ``(full_hit, shared_blocks)``.  Pure function — the router calls it
    per candidate replica."""
    if not summary:
        return (False, 0)
    blocks = summary.get("blocks") or ()
    n = 0
    for d in chain:
        if d not in blocks:
            break
        n += 1
    return (fh in (summary.get("full") or ()), n)
