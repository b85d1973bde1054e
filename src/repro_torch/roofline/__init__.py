"""Roofline terms of the dry run's cells (`analysis`) and the tables
rendered from its records and from kernel profiles (`report`)."""
