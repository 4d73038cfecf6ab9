"""Launch helpers of the port: meshes (``launch.mesh``), the input-shape
cells (``launch.shapes``), the per-cell step builders (``launch.steps``)
and the production dry-run on fake ranks (``launch.dryrun``)."""
