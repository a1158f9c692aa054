"""Paged KV-cache accounting as flat array ledgers (counterpart of
``whisper_trtllm_tpu/runtime/kv_cache_manager.py``, kept as the port's own
copy: pure numpy, the same on either device).

  * ``BlockLedger`` — a refcount vector plus a LIFO free stack (two int32
    arrays and an integer top-of-stack). Taking or releasing N blocks is
    O(N) numpy slicing, never an object walk.
  * ``PagedKVCache`` — a dense (batch, beam, max_blocks_per_seq) int32 block
    table maintained *incrementally*, with per-row owned-block and
    token-length vectors. Advancing the whole batch one token is a masked
    add + modulo test + boolean compaction.

The device-visible artifact is the int32 block table itself, read by the
gathers of ``ops/attention.py::paged_mha_decode_step`` and
``paged_update_kv_cache``. The manager stays on the host: it runs between
decode steps, and a table enters the step as an ordinary int tensor of a
static shape.
"""

from __future__ import annotations

import numpy as np


class BlockLedger:
    """Refcounted block-pool accounting: one refcount vector + a LIFO free
    stack. Blocks are plain int32 pool indices; K and V pools (and every
    layer's pools) are addressed by the same index, so there is no per-block
    state beyond the refcount."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        self._refs = np.zeros(num_blocks, np.int32)
        # stack[:top] holds the free pool indices. Initialised descending so
        # a fresh ledger hands out 0, 1, 2, ... (pops come off the end).
        self._stack = np.arange(num_blocks - 1, -1, -1, dtype=np.int32)
        self._top = num_blocks

    @property
    def num_blocks(self) -> int:
        return self._refs.size

    @property
    def free(self) -> int:
        """Blocks currently on the free stack."""
        return self._top

    def refcount(self, block: int) -> int:
        return int(self._refs[block])

    def take(self, n: int, refs: int = 1) -> np.ndarray:
        """Pop ``n`` blocks off the free stack, each with ``refs`` initial
        links (refs > 1 admits a block born shared, e.g. across beams).
        Raises MemoryError when the pool can't supply ``n`` — the admission
        back-pressure signal continuous batchers act on."""
        if n > self._top:
            raise MemoryError(
                f"paged KV pool exhausted: want {n} block(s), "
                f"{self._top} free of {self._refs.size}")
        got = self._stack[self._top - n:self._top][::-1].copy()
        self._top -= n
        self._refs[got] = refs
        return got

    def ref(self, blocks) -> None:
        """Add one link per entry (repeated indices accumulate)."""
        np.add.at(self._refs, np.asarray(blocks, np.int64).ravel(), 1)

    def unref(self, blocks) -> None:
        """Drop one link per entry (repeated indices accumulate); any block
        whose count reaches zero returns to the free stack."""
        blocks = np.asarray(blocks, np.int64).ravel()
        np.add.at(self._refs, blocks, -1)
        uniq = np.unique(blocks)
        if (self._refs[uniq] < 0).any():
            raise RuntimeError("block refcount underflow (double free)")
        dead = uniq[self._refs[uniq] == 0].astype(np.int32)
        self._stack[self._top:self._top + dead.size] = dead
        self._top += dead.size


class PagedKVCache:
    """Dense-batch sequence lifecycle over a :class:`BlockLedger`.

    Batch row ``b`` of every internal array refers to the b-th *live*
    sequence; retiring sequences compacts all rows with one boolean index,
    so :meth:`block_tables` always lines up with the decode step's lane
    arrays. Context blocks are born shared across beams (``refs=beam``);
    generation-phase growth takes one private block per beam — the sharing
    semantics the reference implements via per-beam lists of linked Block
    objects (kv_cache_manager.py:91-130), done here with a single broadcast
    write into the table.
    """

    def __init__(self, num_blocks: int, tokens_per_block: int,
                 max_blocks_per_seq: int, beam_width: int = 1):
        self.ledger = BlockLedger(num_blocks)
        self.tokens_per_block = int(tokens_per_block)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.beam_width = int(beam_width)
        self._tab = np.full((0, self.beam_width, self.max_blocks_per_seq),
                            -1, np.int32)
        self._owned = np.zeros(0, np.int32)   # table columns in use per row
        self._len = np.zeros(0, np.int32)     # tokens stored per row

    def __len__(self) -> int:
        return self._len.size

    @property
    def lengths(self) -> np.ndarray:
        """Per-row token counts (copy)."""
        return self._len.copy()

    @property
    def owned_blocks(self) -> np.ndarray:
        """Per-row owned table columns (copy)."""
        return self._owned.copy()

    def admit(self, context_len: int) -> int:
        """Admit one sequence holding ``context_len`` prompt tokens,
        reserving beam-shared blocks for the context plus the first
        generated token. Returns the sequence's batch row. The pool is
        checked before any state mutates — a failed admission leaves no
        phantom row behind."""
        if context_len < 0:
            raise ValueError("context_len must be >= 0")
        if self.beam_width > 1 and context_len % self.tokens_per_block:
            # a partial tail block shared across beams would be written
            # divergently by each beam in the generation phase
            raise ValueError(
                f"beam sharing needs block-aligned context: "
                f"{context_len} % {self.tokens_per_block} != 0")
        ctx_blocks = -(-context_len // self.tokens_per_block)  # ceil div
        need = -(-(context_len + 1) // self.tokens_per_block)
        if need > self.max_blocks_per_seq:
            raise ValueError(
                f"context needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq}")
        row = np.full((1, self.beam_width, self.max_blocks_per_seq),
                      -1, np.int32)
        if self.beam_width == 1:
            row[0, :, :need] = self.ledger.take(need)
        else:
            # context blocks are shared; the block receiving the FIRST
            # generated token is private per beam — beams write it
            # divergently from token one (the reference shares it and lets
            # beams clobber each other, kv_cache_manager.py:276-280)
            privates = self.beam_width if need > ctx_blocks else 0
            if self.ledger.free < ctx_blocks + privates:
                raise MemoryError(
                    f"paged KV pool exhausted: want "
                    f"{ctx_blocks + privates} block(s), "
                    f"{self.ledger.free} free")
            row[0, :, :ctx_blocks] = self.ledger.take(
                ctx_blocks, refs=self.beam_width)
            if privates:
                row[0, :, ctx_blocks] = self.ledger.take(privates)
        self._tab = np.concatenate([self._tab, row])
        self._owned = np.append(self._owned, np.int32(need))
        self._len = np.append(self._len, np.int32(context_len))
        return self._len.size - 1

    def advance(self, finished) -> None:
        """One decode step for the whole batch: rows whose next write would
        cross a block boundary get one private block per beam, live rows'
        lengths bump by one, finished rows release their blocks and the
        batch compacts."""
        finished = np.asarray(finished, bool)
        if finished.shape != self._len.shape:
            raise ValueError(
                f"finished mask shape {finished.shape} != batch "
                f"{self._len.shape}")
        live = ~finished
        # token index len(b) is about to be written; it opens a new block
        # exactly when (len+1) crosses a tokens_per_block multiple
        crossing = live & (self._len % self.tokens_per_block
                           == self.tokens_per_block - 1)
        for b in np.flatnonzero(crossing):
            col = self._owned[b]
            if col >= self.max_blocks_per_seq:
                raise RuntimeError(
                    f"row {b} exceeded max_blocks_per_seq "
                    f"{self.max_blocks_per_seq}")
            self._tab[b, :, col] = self.ledger.take(self.beam_width)
            self._owned[b] += 1
        self._len[live] += 1
        if finished.any():
            for b in np.flatnonzero(finished):
                held = self._tab[b][self._tab[b] >= 0]
                if held.size:
                    self.ledger.unref(held)
            self._tab = self._tab[live]
            self._owned = self._owned[live]
            self._len = self._len[live]

    def reorder_beams(self, row: int, parents) -> None:
        """Re-parent ``row``'s beams: beam ``i`` adopts the block list of
        beam ``parents[i]`` (the table-side half of a beam-search reorder;
        the caller copies any partially-written tail block's K/V between
        pool slots — see runtime/beam.py's paged path). Refcounts move with
        the links; beams left childless release their private blocks."""
        parents = np.asarray(parents, np.int64).ravel()
        if parents.shape != (self.beam_width,):
            raise ValueError("parents must have beam_width entries")
        old = self._tab[row].copy()
        new = old[parents]
        held_old = old[old >= 0]
        held_new = new[new >= 0]
        self.ledger.ref(held_new)
        self.ledger.unref(held_old)
        self._tab[row] = new

    def fork_tail(self, row: int) -> np.ndarray:
        """Give every beam of ``row`` a private copy of its (possibly
        shared) last block, returning the (beam, 2) int32 [src, dst] pairs
        whose pool contents the caller must copy. Beams already sole owner
        of their tail keep it (src == dst). Used after reorder_beams, where
        several beams may point at one parent's partially-written tail."""
        col = int(self._owned[row]) - 1
        if col < 0:
            return np.zeros((0, 2), np.int32)
        pairs = np.zeros((self.beam_width, 2), np.int32)
        for bi in range(self.beam_width):
            src = int(self._tab[row, bi, col])
            if self.ledger.refcount(src) > 1:
                dst = int(self.ledger.take(1)[0])
                self.ledger.unref([src])
                self._tab[row, bi, col] = dst
            else:
                dst = src
            pairs[bi] = (src, dst)
        return pairs

    def block_tables(self) -> np.ndarray:
        """(num_live, beam_width, max_blocks_per_seq) int32 pool indices,
        -1 padded — feed directly (or a [:, 0] slice at beam_width 1) to
        ops.attention.paged_mha_decode_step / paged_update_kv_cache."""
        return self._tab.copy()
