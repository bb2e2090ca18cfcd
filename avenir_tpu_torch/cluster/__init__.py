"""Clustering: k-means over mixed records (``kmeans``) and the greedy
edge-weighted agglomerative pass (``agglomerative``)."""
