"""Word counting with analyzer-style tokenization: the port of
``avenir_tpu/text/wordcount.py`` (``tokenize``, ``STANDARD_STOPWORDS``,
``word_count``), read by the text-mode Naive Bayes and ``wordCounter``.

The reference's text path analyzes with Lucene's StandardAnalyzer
(text/WordCounter.java:93, bayesian/BayesianDistribution.java:124-130):
UAX#29 word segmentation, lowercasing and the English stop set; its
reducer counts each word and emits ``word<delim>count`` in word order.
Tokenization and the count are host-side work, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np

# Lucene's ENGLISH_STOP_WORDS_SET, the default for StandardAnalyzer
STANDARD_STOPWORDS = frozenset((
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such", "that",
    "the", "their", "then", "there", "these", "they", "this", "to", "was",
    "will", "with",
))

# UAX#29-style word boundaries, the rules Lucene 4.4's StandardTokenizer
# implements for Latin-script text: unicode alphanumeric runs, joined by
#   - . / apostrophe between letters or between digits (MidNumLet +
#     Single_Quote, WB6/7 + WB11/12: don't, o'neill's, example.com, 3.14)
#   - underscore between alphanumerics (ExtendNumLet: foo_bar stays whole)
_TOKEN_RE = re.compile(
    r"[^\W_]+"
    r"(?:(?:_|(?<=[^\W\d_])['’.](?=[^\W\d_])|(?<=\d)['’.](?=\d))"
    r"[^\W_]+)*",
    re.UNICODE)


def tokenize(text: str, stopwords: frozenset = STANDARD_STOPWORDS
             ) -> List[str]:
    """StandardAnalyzer(Version.LUCENE_44)-equivalent tokenization:
    UAX#29-style word segmentation (see ``_TOKEN_RE``), lowercase, drop
    the English stop set; no stemming.

    Divergences from Lucene, the JAX package's own: ',' between digits
    splits (``1,000`` -> ``1``, ``000``) so no token carries the model
    file's delimiter; leading and trailing underscores are dropped;
    non-Latin segmentation extras (Katakana runs, Thai) are out of
    scope."""
    tokens = _TOKEN_RE.findall(text.lower())
    return [t for t in tokens if t not in stopwords]


def word_count(texts: Sequence[str],
               stopwords: frozenset = STANDARD_STOPWORDS
               ) -> List[Tuple[str, int]]:
    """(word, count) sorted by word (the shuffle's key order): one
    ``np.unique`` over every text's tokens."""
    all_tokens: List[str] = []
    for text in texts:
        all_tokens.extend(tokenize(text, stopwords))
    if not all_tokens:
        return []
    words, counts = np.unique(np.asarray(all_tokens, dtype=object),
                              return_counts=True)
    return [(str(w), int(c)) for w, c in zip(words, counts)]
