"""The Bloom Clock on PyTorch and CUDA (one NVIDIA H100).

A module-for-module port of the JAX package ``repro``.  Plain tensor
code is PyTorch; every Pallas TPU kernel on the ported path is a CUDA
C++ kernel for ``sm_90a`` (``repro_torch.kernels.csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.

Ported so far (the main path, all-pairs, hybrid, serving, the sharded
fleet registry, multi-host gossip):

- ``core``     hashing, the clock, wire frames, history, vector clock,
               the simulator (loopback, mesh, socket and chaos gossip)
- ``kernels``  tick, fused merge+compare, one-vs-many (u8 and i32), the
               fused hybrid sweep, the all-pairs tri, rect-u8,
               rect-i32-stats and mxu kernels
- ``causal``   policy, typed results, ``CausalEngine.classify``/``pairs``
- ``obs``      trace spans, metrics, audit trail, trace export
- ``fleet``    the registry slab (with its eviction hook; on one device
               or row-sharded over a fleet mesh), gossip, the loopback,
               mesh-collective and socket transports, the chaos
               harness, the fleet monitor
- ``launch``   the fleet mesh (``make_fleet_mesh``), with ``sharding``'s
               slot-to-shard helpers, and the socket peers launcher
- ``hybrid``   ``HybridEngine`` (exact hot set over the packed tail) and
               the fp-budget ``AdaptivePolicy``
- ``serve``    the tiered registry (hot card slab, pinned warm tier, cold
               frames), the streaming admission pipeline, the churn
               driver
- ``runtime``  ``ClockRuntime``
- ``convert``  builds the port's objects from the JAX package's state

Entry points (``ClockRuntime``, ``ClockRegistry``, ``HybridEngine``,
``TieredRegistry``, ``run_churn``, ``run_gossip_sim``) run on the card unless the caller passes
``device="cpu"``; functions on tensors follow their tensors' device.  This package never imports
``jax`` or ``repro``.
"""
