"""Launch helpers of the port: meshes (``launch.mesh``)."""
