"""Device meshes and the merges between their shards (port of
``avenir_tpu/parallel``): one process driving an ordered list of torch
devices (``mesh.py``) and the in-process gather onto the merge device
(``collectives.py``).  The multi-process all-reduce is not ported yet."""
