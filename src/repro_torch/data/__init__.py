"""Synthetic data: the request batches the port's models serve
(`recsys_data`) and the token batches its LMs train on (`pipeline`)."""
