"""The port's operator tools, run as modules (``python -m
avenir_tpu_torch.tools.<tool>``): ``registrytool`` (list, verify and gc a
serving registry), ``cachetool`` (inspect, verify and drop an ``.avtc``
columnar cache) and ``tracetool`` (summarize, merge and export traces,
one request's timeline, an incident window, a counters diff).  Each is a
copy of the JAX package's script under ``tools/`` over the port's own
modules, so a user without jax can run them."""
