"""Text analysis: the tokenizer the text-mode Naive Bayes reads."""
