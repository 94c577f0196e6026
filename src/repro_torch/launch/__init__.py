"""Launch helpers: the fleet mesh (``launch.mesh``), the socket gossip
peers (``launch.peers``: peer specs and the multi-process smoke run)
and the serving launcher (``launch.serve``)."""
