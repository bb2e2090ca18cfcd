"""Device meshes and the merges between their shards (port of
``avenir_tpu/parallel``): one process driving an ordered list of torch
devices (``mesh.py``), the in-process gather onto the merge device and the
cross-process ``AllReducer`` (``collectives.py``), and the process identity
and row-range split of a multi-process run (``distributed.py``)."""
