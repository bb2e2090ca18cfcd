"""Device math outside the kernels: the KNN record distance
(``ops/distance.py``)."""
