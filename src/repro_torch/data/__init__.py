"""Synthetic request data the port's models serve (`recsys_data`)."""
