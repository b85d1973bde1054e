"""Launch-time policies: the serving autoscaler (`elastic.AutoscalePolicy`),
the hedging threshold and training-mesh resizing, the device meshes of
scenario sharding, the engine's index servers and the production dry run
(`mesh`), the logical-axis sharding rules (`sharding`), the dry run's
cell specs (`specs`) and the dry run itself (`dryrun`)."""
