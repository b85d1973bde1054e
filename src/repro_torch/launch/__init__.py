"""Launch-time policies: the serving autoscaler (`elastic.AutoscalePolicy`),
the hedging threshold and training-mesh resizing."""
