"""Text analysis: the tokenizer the text-mode Naive Bayes reads and the
word count of ``wordCounter``."""

from .wordcount import STANDARD_STOPWORDS, tokenize, word_count

__all__ = ["STANDARD_STOPWORDS", "tokenize", "word_count"]
