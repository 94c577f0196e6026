"""Launch helpers: the fleet mesh (``launch.mesh``)."""
