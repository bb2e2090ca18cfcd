"""Device math outside the kernels: the KNN record distance
(``ops/distance.py``) and the counting primitives of Naive Bayes
(``ops/histogram.py``)."""
