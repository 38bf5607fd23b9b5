"""Serving: over the offload engine, ``offload_serving``
(``ContinuousOffloadServer``, ``OffloadServer``), ``scheduler``,
``request``; with every weight on the device, ``engine``
(``ServingEngine``); both sample with ``sampler``. Import from the
submodules (the offload engine uses ``sampler``, so this package
imports nothing eagerly)."""
