"""Vectorised copies of the data models in ``resource/gen/``: the benchmark
draws every input from ``--seed`` with these."""
