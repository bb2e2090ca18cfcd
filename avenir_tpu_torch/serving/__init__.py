"""Online prediction serving (port of ``avenir_tpu/serving``): the forest
registry (publish, read, sidecars), warm bucketed predictors (float and
int8), and the micro-batched in-process serving loop.

Deltas, the wire transports, fleets and routers are not ported yet; import
the submodules directly.
"""
