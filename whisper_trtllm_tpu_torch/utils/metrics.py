"""WER, ROUGE and text normalization (the port's own copy of
``whisper_trtllm_tpu/utils/metrics.py``, pure Python).

WER is a word-level Levenshtein over whitespace words; the normalizer is
the English WER protocol of ``utils/normalizer.py``. No optional package
is needed, so WER numbers never depend on what is installed.
"""

from __future__ import annotations

import re
import string
from typing import List, Sequence

from whisper_trtllm_tpu_torch.utils.normalizer import EnglishTextNormalizer


def word_error_rate(hypotheses: Sequence[str], references: Sequence[str]) -> float:
    """Corpus-level WER: total edit distance / total reference words."""
    total_errors = 0
    total_words = 0
    for hyp, ref in zip(hypotheses, references):
        h, r = hyp.split(), ref.split()
        total_errors += _edit_distance(h, r)
        total_words += len(r)
    return total_errors / max(total_words, 1)


def _edit_distance(a: List[str], b: List[str]) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, wa in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, wb in enumerate(b, 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (wa != wb),
            )
        prev = cur
    return prev[-1]


def get_text_normalizer():
    """The WER protocol's EnglishTextNormalizer — the self-contained
    implementation (utils/normalizer.py), always available, so WER numbers
    are leaderboard-comparable with zero optional dependencies."""
    return EnglishTextNormalizer()


_PUNCT = re.compile(f"[{re.escape(string.punctuation)}]")


def basic_normalize(text: str) -> str:
    text = text.lower()
    text = _PUNCT.sub(" ", text)
    return " ".join(text.split())


def _rouge_tokens(text: str) -> List[str]:
    import re

    return re.findall(r"[a-z0-9]+", text.lower())


def _ngram_counts(tokens: List[str], n: int) -> dict:
    counts: dict = {}
    for i in range(len(tokens) - n + 1):
        g = tuple(tokens[i : i + n])
        counts[g] = counts.get(g, 0) + 1
    return counts


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def _f1(match: float, hyp_total: float, ref_total: float) -> float:
    if hyp_total == 0 or ref_total == 0 or match == 0:
        return 0.0
    p, r = match / hyp_total, match / ref_total
    return 2 * p * r / (p + r)


def rouge_scores(hypotheses: Sequence[str], references: Sequence[str]) -> dict:
    """Corpus-mean ROUGE-1/2/L F1 (the reference's summarization metric,
    reference: examples/gpt/summarize.py — there via the `evaluate`/
    rouge_score packages; self-contained here: clipped n-gram overlap F1
    for ROUGE-N, LCS F1 for ROUGE-L, alphanumeric lowercase tokens)."""
    assert len(hypotheses) == len(references)
    sums = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
    for hyp, ref in zip(hypotheses, references):
        h, r = _rouge_tokens(hyp), _rouge_tokens(ref)
        for n, key in ((1, "rouge1"), (2, "rouge2")):
            hc, rc = _ngram_counts(h, n), _ngram_counts(r, n)
            match = sum(min(c, rc.get(g, 0)) for g, c in hc.items())
            sums[key] += _f1(match, max(len(h) - n + 1, 0),
                             max(len(r) - n + 1, 0))
        sums["rougeL"] += _f1(_lcs_len(h, r), len(h), len(r))
    n_items = max(len(hypotheses), 1)
    return {k: v / n_items for k, v in sums.items()}
