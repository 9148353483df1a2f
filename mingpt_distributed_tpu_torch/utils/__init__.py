"""Device selection for the port's entry points."""
