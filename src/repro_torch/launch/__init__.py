"""Launch-time policies (`elastic.hedge_threshold`)."""
