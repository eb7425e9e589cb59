"""Work of one fabric egress step, from its inputs.

Bytes: each word's address and ciphertext read once and its output word and
fault code written once (16 B a word), each row's HWPID (4 B), and each
row's live table entries (start, end, permission bits: 12 B) and tile
summaries (min and max: 8 B) once.  Operations: 52 int32 operations for
the keystream of each granted word (6 set-up, 12 rounds of add, rotate and
xor, 7 key adds, 2 for the position, 1 data xor) and ceil(log2(live
entries)) comparisons a word for the range lookup (none for one entry)."""
from __future__ import annotations

import math

KEYSTREAM_OPS = 52
WORD_BYTES = 16
ENTRY_BYTES = 12
TILE_BYTES = 8
HWPID_BYTES = 4
ENTRIES_PER_TILE = 1024


def lookup_ops(words: int, live_entries: int) -> int:
    """Comparisons a row's range lookup needs: ceil(log2 n) a word."""
    return words * (math.ceil(math.log2(live_entries))
                    if live_entries > 1 else 0)


def step_work(words_per_row: list[int], granted: int,
              live_entries: list[int]) -> tuple[int, int]:
    """(bytes, int32 operations) of one step over rows with
    ``words_per_row[r]`` words and ``live_entries[r]`` live entries, of
    which ``granted`` words in all are released."""
    n_bytes = sum(WORD_BYTES * w + HWPID_BYTES + ENTRY_BYTES * e
                  + TILE_BYTES * max(1, -(-e // ENTRIES_PER_TILE))
                  for w, e in zip(words_per_row, live_entries))
    n_ops = KEYSTREAM_OPS * granted + sum(
        lookup_ops(w, e) for w, e in zip(words_per_row, live_entries))
    return n_bytes, n_ops
