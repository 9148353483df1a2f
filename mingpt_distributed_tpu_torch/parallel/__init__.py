"""Process groups, the dp x sp mesh, and sequence-parallel attention."""
