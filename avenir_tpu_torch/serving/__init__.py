"""Online prediction serving (port of ``avenir_tpu/serving``): the model
registry (publish whole or as a delta, read, sidecars, the serving pin,
retention), warm bucketed predictors (float and int8, with the delta
patch), and the micro-batched serving loop, in-process and over the RESP
wire (``service.RespPredictionLoop``).

Fleets and routers are not ported yet; import the submodules directly.
"""
