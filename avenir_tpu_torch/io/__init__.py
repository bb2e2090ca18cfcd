"""The port's native ingest: the C++ CSV reader behind ``core.table``'s
``load_csv`` and ``iter_csv_chunks`` (``native_csv``, ``csv_native.cpp``)
and the columnar cache sidecar (``colcache``)."""
