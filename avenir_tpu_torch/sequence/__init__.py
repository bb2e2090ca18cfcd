"""Sequence models: Markov chains, HMM and Viterbi (``markov``), the
probabilistic suffix tree, GSP candidates and CTMC statistics (``pst``),
and event-locality clustering (``positional``)."""
