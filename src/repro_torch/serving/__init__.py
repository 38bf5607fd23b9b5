"""Serving over the offload engine: ``offload_serving``
(``ContinuousOffloadServer``, ``OffloadServer``), ``scheduler``,
``request``, ``sampler``. Import from the submodules (the engine uses
``sampler``, so this package imports nothing eagerly)."""
