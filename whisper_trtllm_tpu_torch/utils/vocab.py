"""The synthetic corpus's word list, for reading the trained artifact's ids.

A copy of ``WORDS`` from ``cli/synthetic_asr.py``: each word is one token,
with id ``WORD_ID_BASE + index``. ``artifacts/tiny_en_synth_int8`` was
trained on this vocabulary.
"""

from __future__ import annotations

WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
    "oscar", "papa", "quebec", "romeo", "sierra", "tango", "uniform",
    "victor", "xray", "yankee", "zulu", "amber", "stone", "river",
    "cedar", "ridge", "harbor", "summit",
]
WORD_ID_BASE = 100


def ids_to_text(ids) -> str:
    """Token ids → space-joined words; ids outside the word list (start,
    forced, EOS, pad) are dropped."""
    id2word = {WORD_ID_BASE + i: w for i, w in enumerate(WORDS)}
    return " ".join(id2word[int(t)] for t in ids if int(t) in id2word)
