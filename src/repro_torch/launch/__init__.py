"""Launch-time policies: the serving autoscaler (`elastic.AutoscalePolicy`),
the hedging threshold and training-mesh resizing, and the device meshes
of scenario sharding and the engine's index servers (`mesh`)."""
