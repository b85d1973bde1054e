"""Load and query generators: Poisson / diurnal arrivals and folding
(`loadgen`), Zipf query universes and streams (`querygen`)."""
