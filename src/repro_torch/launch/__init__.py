"""Launch helpers: the model and fleet meshes (``launch.mesh``), the
dry run's abstract inputs and shardings (``launch.specs``) and the dry
run itself (``launch.dryrun``), the socket gossip peers
(``launch.peers``: peer specs and the multi-process smoke run) and the
serving and training launchers (``launch.serve``, ``launch.train``)."""
