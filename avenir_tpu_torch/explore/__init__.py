"""Exploration: rule expressions and their evaluation (``rules``)."""
