"""Online prediction serving (port of ``avenir_tpu/serving``): the registry's
read side for forests, warm bucketed predictors, and the micro-batched
in-process serving loop.

Publishing, deltas, the wire transports, fleets and routers are not ported
yet; import the submodules directly.
"""
