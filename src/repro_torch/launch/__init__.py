"""Launch helpers: the fleet mesh (``launch.mesh``) and the socket
gossip peers (``launch.peers``: peer specs and the multi-process
smoke driver)."""
